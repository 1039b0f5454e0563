"""Build one or more versions of K3's source, hold each against the plain
version and time them in turns, on one card.

    python -m wb_humanoid_mpc_tpu_torch.tools.compare_k3 [SOURCE.cu ...] [--rounds 2] [--phases]

With no source, the package's `csrc/rollout.cu`. Each source is compiled
alone with the kernel library's flags (one `nvcc` each, all started
together), so that an older commit's source, unpacked by `git archive` (the
first, one-block design has the same C entry points), can be timed beside
the current one.

At (N, nx, nu) = (28, 58, 35), (28, 58, 21), (15, 35, 35) and (7, 12, 5),
in f32 and f64, for a batch of 1 and of 4 instances, the tool prints the
cluster design's launch geometry (`rollout_plan`: cluster size, stage slots
per CTA, shared bytes per CTA, `cudaOccupancyMaxActiveClusters`), and in
each round the launch floor (the device time of an empty kernel of the same
grid, cluster shape, block size and shared memory, `tools/launch_floor.py`,
queued behind a sleep kernel as the kernels are), then each source's
error against `forward_rollout_plain` (within `chip_smoke.K3_TOL`, times
max(1, max|ref|)), how many of 20 further launches on the same inputs gave
other bits than the first, and the device time of one launch
(`chip_smoke.kernel_device_ms`). The sources take turns in each round, so a
comparison between them holds on one card. `--phases` also builds each
source that has the phase clock with `-DWBMPC_K3_PHASE_CLOCK` and prints,
at (28, 58, 35) f32 and f64 and (7, 12, 5) f32, batch 1, the SM cycles of
each phase per launch for every rank of the first cluster, and when each
rank started and ended its walk (global timer, ns after rank 0's entry, one
launch). Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib, rollout
from wb_humanoid_mpc_tpu_torch.tools import launch_floor

REPO = Path(__file__).resolve().parents[2]
SHAPES = ((28, 58, 35), (28, 58, 21), (15, 35, 35), (7, 12, 5))
BATCHES = (1, 4)
DTYPES = (torch.float32, torch.float64)
CLOCK_FLAG = "-DWBMPC_K3_PHASE_CLOCK"
MAX_CLUSTER = 8   # rollout.cu's kMaxCluster: the phase clock's rows
PHASES = ("init + copies issued", "folds + hand-off wait", "waits for stages not folded",
          "walk", "refills issued", "hand-off sent", "outputs + cluster barrier")
PHASE_SHAPES = (((28, 58, 35), torch.float32), ((28, 58, 35), torch.float64),
                ((7, 12, 5), torch.float32))


def build(sources: list[Path], phases: bool = False):
    """(a library per source, and a phase-clock library per source: None
    without `phases` or where the source has no clock)."""
    out_dir = _lib.BUILD_DIR / "compare_k3"
    out_dir.mkdir(parents=True, exist_ok=True)
    clocked = [src for src in sources if phases and CLOCK_FLAG[2:] in src.read_text()]
    jobs = [(src, [], out_dir / f"{src.stem}_{_lib._digest([src])}.so") for src in sources]
    jobs += [(src, [CLOCK_FLAG], out_dir / f"{src.stem}_clock_{_lib._digest([src])}.so")
             for src in clocked]
    todo = [job for job in jobs if not job[2].exists()]
    logs = _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, *flags, "-shared", str(src), "-o",
                           str(so)] for src, flags, so in todo])
    for (src, flags, _), log in zip(todo, logs):   # -Xptxas -v: registers, stack frame, spills
        for line in log.splitlines() if not flags else ():
            if "registers" in line or "stack frame" in line:
                print(f"  ptxas {src.name}: {line.strip()}")
    libs = []
    for _, _, so in jobs:
        lib = ctypes.CDLL(str(so))
        for name in ("wbmpc_forward_rollout_f32", "wbmpc_forward_rollout_f64"):
            getattr(lib, name).argtypes = _lib._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs.append(lib)
    clocks = iter(libs[len(sources):])
    clock_libs = [next(clocks) if src in clocked else None for src in sources]
    for lib in clock_libs:
        if lib is not None:
            lib.wbmpc_rollout_phase_clock.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
            lib.wbmpc_rollout_phase_clock.restype = ctypes.c_int
    return libs[:len(sources)], clock_libs


def _launcher(lib, args, outs, batch):
    N, nx, nu = args[0].shape[-3], args[0].shape[-1], args[1].shape[-1]
    fn = lib.wbmpc_forward_rollout_f32 if args[0].dtype == torch.float32 \
        else lib.wbmpc_forward_rollout_f64
    ptrs = [a.data_ptr() for a in args] + [o.data_ptr() for o in outs]

    def launch():
        code = fn(*ptrs, batch, N, nx, nu, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"rollout launch: CUDA error {code}")
    return launch


def phase_report(src: Path, lib, device_ms) -> None:
    """Print the phase clock of `lib` (a phase-clock build) at PHASE_SHAPES."""
    cycles = (ctypes.c_ulonglong * (MAX_CLUSTER * 7))()
    ns = (ctypes.c_ulonglong * (MAX_CLUSTER * 3))()

    def read(reset):
        code = lib.wbmpc_rollout_phase_clock(cycles, ns, int(reset))
        if code != 0:
            raise RuntimeError(f"phase clock: CUDA error {code}")
        return (np.array(cycles[:], dtype=np.float64).reshape(MAX_CLUSTER, 7),
                np.array(ns[:], dtype=np.float64).reshape(MAX_CLUSTER, 3))

    for shape, dtype in PHASE_SHAPES:
        ins = stage_tensors(1, *shape, dtype, 1)
        outs = [torch.empty_like(r) for r in rollout.forward_rollout_plain(*ins)]
        launch = _launcher(lib, ins, outs, 1)
        count = [0]

        def counted():
            launch()
            count[0] += 1

        torch.cuda.synchronize()
        read(reset=True)
        ms = device_ms(counted, 50)
        cyc, stamps = read(reset=True)
        cyc /= count[0]
        n_ranks = rollout.rollout_plan(*shape, dtype)["cluster"]
        print(f"phases {src.name} {shape} {str(dtype)[6:]}: instrumented "
              f"kernel {ms * 1e3:.3f} us on the device; SM cycles per launch by rank "
              f"({' | '.join(PHASES)}); walk start and end, ns after rank 0's entry")
        t0 = stamps[0, 0]
        for r in range(n_ranks):
            print(f"  rank {r}: " + " | ".join(f"{c:.0f}" for c in cyc[r])
                  + f" | sum {cyc[r].sum():.0f}; walk {stamps[r, 1] - t0:.0f} .. "
                  f"{stamps[r, 2] - t0:.0f} ns")


def stage_tensors(seed, N, nx, nu, dtype, batch):
    r = np.random.default_rng(seed)
    parts = [rollout.random_stage_data(r, N, nx, nu, dtype=np.float64) for _ in range(batch)]
    return [torch.as_tensor(np.stack([p[k] for p in parts]), dtype=dtype, device="cuda")
            for k in ("A", "B", "d", "K", "k", "dx0")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", action="store_true",
                    help="also print each rank's SM cycles by phase (phase-clock builds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k3: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    sources = args.sources or [_lib.CSRC / "rollout.cu"]
    libs, clock_libs = build(sources, phases=args.phases)
    empty_lib = launch_floor.build()
    print(chip_smoke.card_line())
    cases = []
    for dtype in DTYPES:
        for shape in SHAPES:
            for batch in BATCHES:
                ins = stage_tensors(sum(shape) + batch, *shape, dtype, batch)
                ref = rollout.forward_rollout_plain(*ins)
                plan = rollout.rollout_plan(*shape, dtype)
                label = f"{shape} {str(dtype)[6:]} batch={batch}"
                print(f"plan {label}: cluster {plan['cluster']}, {plan['slots']} stage slots a "
                      f"CTA, {plan['smem_bytes']} shared bytes a CTA, at most "
                      f"{plan['max_active_clusters']} clusters at once")
                cases.append((label, dtype, batch, ins, ref, plan))
    ok = True
    for rnd in range(args.rounds):
        parts = []
        for label, _, batch, _, _, plan in cases:
            floor = launch_floor.empty_launcher(empty_lib, batch, plan["cluster"],
                                                plan["threads"], plan["smem_bytes"])
            parts.append(f"{label} {chip_smoke.kernel_device_ms(floor, 50) * 1e3:.3f} us")
        print(f"round {rnd} launch floor (empty kernel, the plan's grid and cluster): "
              + " | ".join(parts), flush=True)
        for src, lib in zip(sources, libs):
            parts = []
            for label, dtype, batch, ins, ref, _ in cases:
                outs = [torch.full_like(r, float("nan")) for r in ref]
                launch = _launcher(lib, ins, outs, batch)
                launch()
                torch.cuda.synchronize()
                tol = chip_smoke.K3_TOL["f32" if dtype == torch.float32 else "f64"]
                try:
                    err = chip_smoke.scaled_err(outs, ref, tol, f"{src} {label}")
                except AssertionError as e:
                    ok = False
                    parts.append(f"{label} FAILED: {e}")
                    continue
                first = [o.clone() for o in outs]
                differ = 0
                for _ in range(20):
                    launch()
                    differ += not all(torch.equal(a, b) for a, b in zip(outs, first))
                ms = chip_smoke.kernel_device_ms(launch, 50)
                parts.append(f"{label} {ms * 1e3:.3f} us (err {err:.2e}, {differ}/20 "
                             f"launches with other bits)")
            print(f"round {rnd} {src}: " + " | ".join(parts), flush=True)
    for src, lib in zip(sources, clock_libs):
        if lib is not None:
            phase_report(src, lib, chip_smoke.kernel_device_ms)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
