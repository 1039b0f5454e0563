"""Build one or more versions of K2's source, hold each against the plain
version and time them in turns, on one card.

    python -m wb_humanoid_mpc_tpu_torch.tools.compare_k2 [SOURCE.cu ...] [--rounds 2]

With no source, the package's `csrc/fkvel.cu`. Each source is compiled
alone with the kernel library's flags (one `nvcc` each, all started
together). A source takes either the level tables of
`ops/fkvel.py::_tables` or the joint-order tables of the first K2 design
(`order`, `parent`, `jR`, `jp`, `axis`; recognised by its `const int* order`
parameter), so an older commit's source, unpacked by `git archive`, can be
timed beside the current one.

For humanoid23 at B = 1, 28, 56, 130, 168 and 224, in f32 and f64, the tool
prints each source's error against `fkvel_plain` (f32 within
`chip_smoke.K2_TOL`, f64 within 1e-9) and the device time of one launch
(`chip_smoke.kernel_device_ms`: launches queued behind a sleep kernel), and
for each B the launch floor: the device time of an empty kernel of the same
grid (`tools/launch_floor.py`), queued the same way. `--phases` also
builds each level-table source with `-DWBMPC_K2_PHASE_CLOCK` and splits
block 0's SM cycles by phase (copies in, sin/cos, joint rotations and base,
tree walk, copies out) at B = 28 and 224. The sources
take turns in each round, so a comparison between them holds on one card.
Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib, fkvel
from wb_humanoid_mpc_tpu_torch.tools import launch_floor

REPO = Path(__file__).resolve().parents[2]
BATCHES = (1, 28, 56, 130, 168, 224)
DTYPES = (torch.float32, torch.float64)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the first design's entry point: q, v, order, parent, jR, jp, axis, gravity,
# R, p, vb, axes, E, B, n_j, stream
_ORDER_SIGNATURE = [_P] * 7 + [_D] + [_P] * 5 + [_I, _I, _P]
CLOCK_FLAG = "-DWBMPC_K2_PHASE_CLOCK"
PHASES = ("copies in", "sin/cos", "joint rotations + base", "tree walk", "copies out (issued)")


def _bind(so: Path, by_order: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name in ("wbmpc_fkvel_f32", "wbmpc_fkvel_f64"):
        getattr(lib, name).argtypes = _ORDER_SIGNATURE if by_order else _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.by_order = by_order
    return lib


def _build(sources: list[Path], phases: bool):
    """(a library per source, the empty kernel's library, a phase-clock
    library per level-table source or None)."""
    out_dir = _lib.BUILD_DIR / "compare_k2"
    out_dir.mkdir(parents=True, exist_ok=True)
    by_order = [("const int* order" in src.read_text()) for src in sources]
    jobs = [(src, [], out_dir / f"{src.stem}_{_lib._digest([src])}.so") for src in sources]
    if phases:
        jobs += [(src, [CLOCK_FLAG], out_dir / f"{src.stem}_clock_{_lib._digest([src])}.so")
                 for src, old in zip(sources, by_order) if not old]
    todo = [job for job in jobs if not job[2].exists()]
    logs = _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, *flags, "-shared", str(src), "-o",
                           str(so)] for src, flags, so in todo])
    for (src, flags, _), log in zip(todo, logs):   # -Xptxas -v: registers, stack frame, spills
        for line in log.splitlines():
            if not flags and ("Compiling entry" in line or "registers" in line
                              or "stack frame" in line):
                print(f"  ptxas {src.name}: {line.strip()}")
    libs = [_bind(so, old) for (_, _, so), old in zip(jobs, by_order)]
    clocks = iter(_bind(so, False) for _, _, so in jobs[len(sources):])
    clock_libs = [next(clocks) if phases and not old else None for old in by_order]
    for lib in clock_libs:
        if lib is not None:
            lib.wbmpc_fkvel_phase_cycles.argtypes = [_P, _I]
            lib.wbmpc_fkvel_phase_cycles.restype = ctypes.c_int
    return libs, launch_floor.build(), clock_libs


def _phase_cycles(lib, launch, device_ms) -> tuple[np.ndarray, float]:
    """(SM cycles per phase of block 0, device ms) per launch, over the
    launches `device_ms(launch, 50)` makes."""
    out = (ctypes.c_ulonglong * len(PHASES))()

    def read(reset):
        code = lib.wbmpc_fkvel_phase_cycles(out, int(reset))
        if code != 0:
            raise RuntimeError(f"phase clock: CUDA error {code}")
        return np.array(out[:], dtype=np.float64)

    count = [0]

    def counted():
        launch()
        count[0] += 1

    torch.cuda.synchronize()
    read(reset=True)
    ms = device_ms(counted, 50)
    return read(reset=True) / count[0], ms


def _order_tables(robot, dtype):
    """The first design's tables: joints in level order, parents, jR, jp, axis."""
    from wb_humanoid_mpc_tpu_torch.models.kinematics import _tree_levels

    parents = tuple(int(p) for p in robot.joint_parent_body)
    order = [int(j) for idx in _tree_levels(parents) for j in idx]

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device="cuda").contiguous()

    return (t(order, torch.int32), t(parents, torch.int32), t(robot.joint_R, dtype),
            t(robot.joint_p, dtype), t(robot.joint_axis, dtype))


def _launcher(lib, robot, q, v, outs):
    """A function that launches `lib`'s kernel once on q, v into outs."""
    B, n_j = q.shape[0], robot.n_joints
    fn = lib.wbmpc_fkvel_f32 if q.dtype == torch.float32 else lib.wbmpc_fkvel_f64
    if lib.by_order:
        tables = _order_tables(robot, q.dtype)
        tail = [B, n_j]
    else:
        joints, geo, n_levels = fkvel._tables(robot, q.device, q.dtype)
        tables = (joints, geo)
        tail = [B, n_j, n_levels]
    ptrs = [t.data_ptr() for t in tables] + [float(robot.gravity)]
    ptrs += [o.data_ptr() for o in outs]

    def launch():
        code = fn(q.data_ptr(), v.data_ptr(), *ptrs, *tail,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"fkvel launch: CUDA error {code}")

    launch.tables = tables   # the kernel reads them: keep them allocated while `launch` lives
    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", action="store_true",
                    help="also split block 0's SM cycles by phase at B = 28 and 224")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k2: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, load_wb_model
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")   # TF32 off, as on the solver's path
    sources = args.sources or [_lib.CSRC / "fkvel.cu"]
    libs, empty_lib, clock_libs = _build(sources, args.phases)
    print(chip_smoke.card_line())
    robot = load_wb_model(ASSETS / "humanoid23")[1].robot
    rng = np.random.default_rng(0)
    cases = []
    for dtype in DTYPES:
        for B in BATCHES:
            q = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.3, dtype=dtype, device="cuda")
            v = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.5, dtype=dtype, device="cuda")
            fk, vb = fkvel.fkvel_plain(robot, q, v)
            ref = (fk.R, fk.p, torch.stack([vb.v_o, vb.omega, vb.a_o, vb.domega], 2),
                   fk.joint_axis_w, fk.E_base)
            cases.append((dtype, B, q, v, ref))
    ok = True
    for rnd in range(args.rounds):
        parts = []
        for B in BATCHES:
            empty = launch_floor.empty_launcher(empty_lib, B, 1, 32, 0)
            parts.append(f"B={B} {chip_smoke.kernel_device_ms(empty, 50) * 1e3:.3f} us")
        print(f"round {rnd} launch floor (empty kernel, B blocks of 32 threads): "
              + " | ".join(parts), flush=True)
        for src, lib in zip(sources, libs):
            parts = []
            for dtype, B, q, v, ref in cases:
                outs = fkvel._outputs(B, robot.n_bodies, robot.n_joints, q)
                launch = _launcher(lib, robot, q, v, outs)
                launch()
                torch.cuda.synchronize()
                tol = chip_smoke.K2_TOL if dtype == torch.float32 else dict(rtol=1e-9, atol=1e-9)
                label = f"B={B} {str(dtype)[6:]}"
                try:
                    err = chip_smoke.max_err(outs, ref, what=f"{src.name} {label}", **tol)
                except AssertionError as e:
                    ok = False
                    parts.append(f"{label} FAILED: {e}")
                    continue
                ms = chip_smoke.kernel_device_ms(launch, 50)
                parts.append(f"{label} {ms * 1e3:.3f} us (err {err:.2e})")
            print(f"round {rnd} {src}: " + " | ".join(parts), flush=True)
    if args.phases:
        for src, lib in zip(sources, clock_libs):
            for dtype, B, q, v, _ in (cases if lib is not None else []):
                if B not in (28, 224):
                    continue
                outs = fkvel._outputs(B, robot.n_bodies, robot.n_joints, q)
                cyc, ms = _phase_cycles(lib, _launcher(lib, robot, q, v, outs),
                                        chip_smoke.kernel_device_ms)
                parts = " | ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cyc))
                print(f"phases {src.name} B={B} {str(dtype)[6:]}: {parts} | sum "
                      f"{cyc.sum():.0f} SM cycles; instrumented kernel {ms * 1e3:.3f} us on "
                      f"the device")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
