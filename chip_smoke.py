#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wb_humanoid_mpc_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives these paths,
all at N = 28 on the 29-DoF `humanoid23` model (nx 58, nu 35, 14 equality
rows), the stance setup of `bench.py`, in float32:

- the main path: warm-started whole-body SQP iterations (projection +
  filter), through K1 (`riccati.cu`) and K2 (`fkvel.cu`);
- the compiled solve (`graphs` phase): the main path's solve as CUDA graphs
  (`solver/graphs.py`, `make_sqp_solver`'s default on the card) against its
  eager twin (`graphs=False`): the same result, K1 and K2 per iteration
  under replay, capture seconds and memory, each graph's device time
  against the wall time, and ten alternating pairs of it/s and p50;
- the split LQ solve: the sequential `backward_pass` then K3
  (`rollout.cu`, one thread-block cluster per instance), on the main path's
  projected LQ (nz 21) and on the AL path's unprojected one (nu 35), against
  `forward_pass` and K1's fused solve;
- every other solver configuration (AL + merit, parallel Riccati, midpoint
  and exact sensitivities, DDP, the staged solver), a few warm-started
  solves each, against the same configuration on the plain versions; the
  staged solver's phase graphs against its eager twin (the same solution
  and launches, each phase's device ms, phase seconds in turns);
- the closed loop of both formulations (`build_*_mpc` + the dummy sim,
  whose plant steps as a CUDA graph: against its eager twin, ms a step in
  turns);
- the MRT host runtime of both formulations: `MrtPipeline`'s solver thread
  on the card beside a 500 Hz control loop (replay plant, native seqlock,
  the MRT controller's feed-forward as a CUDA graph on its own stream,
  native `control_tick`); the controller alone, graphed against eager in
  turns, its graph's device ms, its device and host time per tick alone
  and beside the solver thread, and a new controller's first tick (its
  capture) beside a solver thread that is capturing its solve;
- the batched solve: B = 8 against 8 unbatched solves and against its plain
  run, a sweep of B up to the largest that fits (at most 256), K1 at a
  leading batch of 8, 64 and that B, and K2 at the sweep's row counts
  (B x 28 and 2 B x 28) at B = 64 and that B;
- the 2-D (batch x horizon) sharded solve, the port's `dryrun_multichip`:
  the walking schedule, 2 SQP iterations, f32 and f64, on a 1x1 mesh
  (`nccl`) and on 1x4 and 2x4 meshes of `gloo` ranks on this one card
  (`parallel/multihost.py::run_ranks`), as CUDA graphs against its eager
  twin (and both against `make_batched_solver`), K2 and the collectives
  per iteration under replay, ms an iteration graphed and eager in turns,
  and K2 at the sharded path's row counts;
- the launch CLI in-process, as a user runs it: `dummy-sim --formulation wb`
  (1.0 s at 50 / 25 Hz, `--log-csv`; its plant step graphed against eager)
  and `bench-batched --batch 8`;
- the port's bench entry in-process, as a user runs it
  (`tools.bench.main(["--timed", "20", "--latency-samples", "5"])`: its
  JSON line, K1 once per solve), then `scaling_report((1, 8))`;
- where the machine has `mujoco` (found by `importlib.util.find_spec`), the
  MuJoCo physics loop on humanoid23's MJCF: `run_mujoco_closed_loop`
  synchronous for both formulations and with a 12 ms solve latency
  (centroidal), and the three-thread `run_threaded_robot_sim`; without
  mujoco it prints a line that says so and runs none of it.

Every path but the DDP solver runs its SQP solves as CUDA graphs, as a
user gets them on the card (the staged solver one graph a phase, the
sharded solver one graph a part between its collectives on `gloo` and one
an iteration on `nccl`), and so do the MRT controllers and the dummy plant;
a replay adds the launches its graph holds to the kernels' counts (and the
collectives it holds to theirs). Each graph is held
against its eager twin at GRAPH_TOL x max(1, max|ref|) (the same kernels
on the same values: expected 0). Each path checks that its kernels
were launched as the configuration implies, that the result is finite and
that it agrees with the plain versions. The checks of a path's last kernel
launch against the plain version read it through `LaunchRecorder`: under
capture it keeps copies of the launch's inputs and outputs that every
replay refreshes, so they check the launch of the graph's last replay (the
mrt and launch phases' timings hold those copies; the graphs phase prints
what they cost). Count-only recorders count the main path's launches on the
device, which must equal the wrappers' counts, and the batched sweep's by
row count. Any failure exits non-zero. The last line is the device JSON; the
line before it lists the kernels with their launches, errors, times and
bounds (and, for K3, the launch floor: an empty kernel of its cluster
grid). Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks: 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
# the tensor cores, 3.35 TB/s device memory, 132 SMs (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
N_SMS = 132
N_NODES = 28
K2_TOL = dict(rtol=1e-4, atol=5e-6)   # the Mosaic tolerance of tests/test_ops_fkvel.py
# K2's flow variant against the plain flow map in float64 on the same inputs:
# the flow map's float32 tolerance of tests/test_torch_fkvel.py
FLOW_TOL = dict(rtol=2e-4, atol=2e-5)
K1_TOL = dict(rtol=1e-3, atol=5e-4)   # tests/test_ops_riccati.py Mosaic tier
K3_TOL = {"f32": 1e-5, "f64": 1e-12}  # x max(1, max|ref|): tests/test_ops_rollout.py
SOLVE_TOL = 2e-3                      # x max(1, max|ref|): kernels vs plain, whole solves
GRAPH_TOL = 1e-6                      # x max(1, max|ref|): a graph vs its eager twin (expected 0)


def clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now, as
    `nvidia-smi` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean device time of fn() over n back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_device_ms(fn, n: int) -> float:
    """Mean device time of one fn() (one kernel launch) over n launches queued
    behind a sleep kernel: the host enqueues all n while the card sleeps, so
    the CUDA events around them time the kernels back to back, without the
    host time of their wrapper (which, for a kernel of a few microseconds,
    is what plain back-to-back timing measures). `torch.profiler` was tried
    first and drops kernel events on this card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 1_000_000   # 4x the enqueue time at up to 2 GHz
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()   # the card still slept when the last launch was queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError("could not queue the launches ahead of the card")


def max_err(a, b, rtol, atol, what):
    """Max |a - b| over matching tensors; raise if any exceeds atol + rtol |b|."""
    import torch

    worst = 0.0
    for x, y in zip(a, b):
        diff = (x - y).abs()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: kernel output not finite")
        if bool((diff > atol + rtol * y.abs()).any()):
            raise AssertionError(f"{what}: max |kernel - plain| = {float(diff.max()):.3e} "
                                 f"beyond atol {atol} rtol {rtol}")
        worst = max(worst, float(diff.max()))
    return worst


def fkvel_work(B: int, n_j: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) the FK pass must move and do: q and v read once,
    R, p, vb, axes, E written once; per joint 278 operations (Rodrigues
    matrix 81, two 3x3 products 90, three 3x3 mat-vecs 45, four cross
    products 36, the twist/bias updates 24, sin and cos 2), 71 for the base."""
    nq, n_b = 6 + n_j, n_j + 1
    values = B * (2 * nq + n_b * (9 + 3 + 12) + 3 * n_j + 9)
    return values * itemsize, B * (278.0 * n_j + 71.0)


def fkvel_flow_work(B: int, n_j: int, n_c: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of K2's flow variant: xs and us read once, x_dot
    written once; the tree pass's operations (`fkvel_work`), then per body
    300 (R c, two R I R^T, five cross products, F and two mat-vecs), per
    body and column of M's base rows 60, and 200 for the sums, rhs and the
    6x6 solve."""
    nq, n_b = 6 + n_j, n_j + 1
    values = B * (2 * nq + 6 * n_c + n_j + 2 * nq)
    ops = 278.0 * n_j + 71.0 + 300.0 * n_b + 60.0 * n_b * nq + 12.0 * n_j + 200.0
    return values * itemsize, B * ops


def flow_vs_plain(model, xs, us, got, what: str) -> float:
    """max |flow variant - plain| against the plain flow map in float64 on
    the same inputs; raise beyond FLOW_TOL."""
    ref = model.flow_map_batch(None, xs.double(), us.double(), backend="plain")
    return max_err([got.double()], [ref], what=what, **FLOW_TOL)


def riccati_work(batch: int, N: int, nx: int, nu: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of the fused solve: every stage's A, B, d, Qxx,
    Quu, Qux, qx, qu and QN, qN, dx0 read once, K, k, dxs, dus written once;
    per stage P A, A'PA (2 nx^3 each), P B, B'PA (2 nx^2 nu each), B'PB
    (2 nx nu^2), the elimination (2 nu^2 (nu + nx + 1)), Qux_h'K (2 nx^2 nu),
    the vector products (4 nx^2 + 4 nx nu) and the rollout
    (2 nx^2 + 4 nx nu)."""
    w = nu + nx + 1
    stage = (4 * nx ** 3 + 6 * nx ** 2 * nu + 2 * nx * nu ** 2 + 2 * nu ** 2 * w
             + 6 * nx ** 2 + 8 * nx * nu)
    inputs = N * (2 * nx * nx + nx * nu + nu * nu + nu * nx + 2 * nx + nu) + nx * nx + 2 * nx
    outputs = N * (nu * nx + nu + nu) + (N + 1) * nx
    return batch * (inputs + outputs) * itemsize, batch * N * float(stage)


def rollout_work(batch: int, N: int, nx: int, nu: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of the forward rollout: every stage's A, B, d, K,
    k and dx0 read once, dxs and dus written once; per stage K dx + k
    (2 nx nu + nu) and A dx + B du + d (2 nx^2 + 2 nx nu + nx)."""
    inputs = N * (nx * nx + 2 * nx * nu + nx + nu) + nx
    outputs = (N + 1) * nx + N * nu
    stage = 4 * nx * nu + 2 * nx * nx + nx + nu
    return batch * (inputs + outputs) * itemsize, batch * N * float(stage)


def scaled_err(a, b, tol: float, what: str) -> float:
    """max |a - b| over matching tensors; raise if it exceeds tol max(1, max|b|)."""
    import torch

    worst = 0.0
    for x, y in zip(a, b):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: output not finite")
        err = float((x - y).abs().max())
        limit = tol * max(1.0, float(y.abs().max()))
        if not err <= limit:
            raise AssertionError(f"{what}: max |got - ref| = {err:.3e} beyond {limit:.3e}")
        worst = max(worst, err)
    return worst


def k1_solver_err(got, ref, what: str) -> tuple[float, float]:
    """(max |K1 - plain|, the largest ratio of |K1 - plain| to its limit)
    over K1's outputs on a solver's LQ data, whose gains reach ~1e2: the
    limit is K1_TOL's atol x max(1, max|ref|) of each output + rtol |ref|
    (tests/test_torch_cuda.py's convention for K1 on the AL path's LQ).
    Raises if an output is not finite or a ratio exceeds 1."""
    import torch

    err, ratio = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what} output {i}: not finite")
        diff = (a - b).abs()
        limit = K1_TOL["atol"] * max(1.0, float(b.abs().max())) + K1_TOL["rtol"] * b.abs()
        err, ratio = max(err, float(diff.max())), max(ratio, float((diff / limit).max()))
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: max |K1 - plain| {err:.3e}, {ratio:.3f} of its limit")
    return err, ratio


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _recording(runtime, riccati, fkvel):
    """Wrap runtime.advance to record, per solve, its time t0, its stats, the
    policy's xs, us and contact flags, and the K1 and K2 launches it made."""
    orig = runtime.advance
    record = []

    def advance(t0, *args, **kwargs):
        before = (riccati.LAUNCHES, fkvel.LAUNCHES)
        stats = orig(t0, *args, **kwargs)
        pol = runtime.policy
        record.append(dict(t0=t0, stats=stats, xs=pol.xs.copy(), us=pol.us.copy(),
                           flags=pol.contact_flags.copy(), k1=riccati.LAUNCHES - before[0],
                           k2=fkvel.LAUNCHES - before[1]))
        return stats

    runtime.advance = advance
    return record


def closed_loops(torch, riccati, fkvel, rollout, card: str) -> dict:
    """`build_wb_mpc` / `build_centroidal_mpc` + `run_dummy_sim` on
    humanoid23 at N = 28, f32, the builders' iteration count (2): a 1.0 s
    stance run at 50 Hz plant / 25 Hz MPC (25 solves) per formulation and,
    whole-body, a 1.2 s run with `request_gait("trot")` at t = 0.3 s; the
    plant steps as CUDA graphs, as `run_dummy_sim` takes them on the card.
    The first 3 ticks of each stance run are held against the same loop on
    the plain versions; the behaviour checks mirror tests/test_dummy_sim.py;
    the stance run's plant step, graphed against eager, by
    `plant_step_report`."""
    from wb_humanoid_mpc_tpu_torch.core.config import load_reference_config, load_task_config
    from wb_humanoid_mpc_tpu_torch.interface import (
        ASSETS,
        build_centroidal_mpc,
        build_wb_mpc,
        mpc_files,
    )
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim

    out = {}
    for form, build in (("wb", build_wb_mpc), ("centroidal", build_centroidal_mpc)):
        files = mpc_files(ASSETS / "humanoid23", form)
        kw = dict(n_nodes=N_NODES)
        if form == "wb":   # dt from the task file; the centroidal dt = horizon / N
            kw["dt_override"] = load_task_config(files[1], "wb", 1, 1).sqp.dt
        mpc = build(*files, **kw, device="cuda")
        plain = build(*files, **kw, solver_overrides=dict(rollout_backend="plain",
                                                          flow_backend="plain"), device="cuda")
        nx, nu = mpc.model.state_dim, mpc.model.input_dim
        z_idx = 8 if form == "centroidal" else 2
        n_j = mpc.model.layout.n_joints
        z_ref = load_reference_config(files[2], n_j).default_base_height
        print(f"closed loop {form}: humanoid23 nx {nx} nu {nu} n_eq {mpc.ocp.n_eq} N "
              f"{mpc.n_nodes} dt {mpc.dt:.6g} horizon {mpc.n_nodes * mpc.dt:.6g} s, f32, "
              f"50 Hz plant / 25 Hz MPC, graphed solves (the recovery solve replays the "
              f"solve's graphs) and plant steps")

        # one solve first: the timings below are of a warm process
        mpc.runtime.advance(0.0, mpc.initial_state, np.zeros(4))
        runs = [("stance", 1.0, None)]
        if form == "wb":
            runs.append(("trot", 1.2, 0.3))
        result = {}
        for run, duration, trot_at in runs:
            rt = mpc.runtime
            rt.reset()
            record = _recording(rt, riccati, fkvel)
            fired, gaits = [], []

            def command_fn(t, trot_at=trot_at, fired=fired, gaits=gaits, mm=mpc.motion_manager):
                if trot_at is not None and t >= trot_at and not fired:
                    mm.request_gait("trot")
                    fired.append(t)
                gaits.append(mm.current_gait)
                return np.zeros(4)

            for mod in (riccati, fkvel, rollout):
                mod.reset_launches()
            t0 = time.perf_counter()
            log = run_dummy_sim(rt, mpc.initial_state, duration, 50.0, 25.0,
                                command_fn=command_fn, flow=mpc.model.flow_map)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES, "K3": rollout.LAUNCHES}
            del rt.advance   # the recording wrapper
            stats = [r["stats"] for r in record]
            # launch counts, the normal and the recovery solves apart
            for rec in (False, True):
                sel = [r for r in record if r["stats"].recovery == rec]
                n_it = sum(r["stats"].iterations for r in sel)
                k1, k2 = sum(r["k1"] for r in sel), sum(r["k2"] for r in sel)
                if k1 != n_it:
                    raise AssertionError(f"closed loop {form} {run}: K1 launched {k1} times in "
                                         f"{n_it} SQP iterations (recovery solves: {rec})")
                lo, hi = (6 * n_it, 9 * n_it) if form == "wb" else (0, 0)
                if not lo <= k2 <= hi:
                    raise AssertionError(f"closed loop {form} {run}: K2 launched {k2} times in "
                                         f"{n_it} SQP iterations, expected {lo}..{hi}")
            if (launches["K1"] != sum(r["k1"] for r in record)
                    or launches["K2"] != sum(r["k2"] for r in record) or launches["K3"] != 0):
                raise AssertionError(f"closed loop {form} {run}: launches outside the solves "
                                     f"{launches}")
            # behaviour (tests/test_dummy_sim.py)
            if not np.isfinite(log.states).all():
                raise AssertionError(f"closed loop {form} {run}: non-finite state")
            z = log.states[:, z_idx]
            if run == "stance":
                if not np.abs(z - z_ref).max() < 0.03:
                    raise AssertionError(f"closed loop {form} stance: base height "
                                         f"{z.min():.4f}..{z.max():.4f} vs {z_ref}")
                if not (log.contact_flags > 0.5).all():
                    raise AssertionError(f"closed loop {form} stance: a foot left the ground")
                worst_g = max(s_.g_norm for s_ in stats)
                if not worst_g < 5e-2:
                    raise AssertionError(f"closed loop {form} stance: g_norm {worst_g:.3e}")
                kernel_record = record
            else:
                # the request applies at the next solve; the solves after it
                # plan single-support phases (the 0.4 s transition stance and
                # the insertion point put them beyond this run's end)
                if "trot" not in gaits:
                    raise AssertionError("closed loop wb trot: the request never applied")
                planned = [r for r in record if r["t0"] >= fired[0]]
                if not any((r["flags"].sum(axis=1) < 2).any() for r in planned):
                    raise AssertionError("closed loop wb trot: no single-support phase planned")
            solve_ms = np.array([s.solve_time for s in stats]) * 1e3
            ref_ms = np.array([s.reference_time for s in stats]) * 1e3
            row = dict(solves=len(stats), recovery_solves=sum(s.recovery for s in stats),
                       iterations=sum(s.iterations for s in stats),
                       solve_ms_p50=float(np.percentile(solve_ms, 50)),
                       solve_ms_p90=float(np.percentile(solve_ms, 90)),
                       reference_ms_p50=float(np.percentile(ref_ms, 50)),
                       ticks_per_s=len(log.times) / wall, n_warm_resets=rt.n_warm_resets,
                       launches=launches, g_norm_max=float(max(s.g_norm for s in stats)),
                       height=[float(z.min()), float(z.max())],
                       single_support_ticks=int((log.contact_flags.sum(axis=1) < 2).sum()))
            result[run] = row
            print(f"closed loop {form} {run}: {row['solves']} solves ({row['recovery_solves']} "
                  f"recovery), {row['iterations']} SQP iterations; solve p50 "
                  f"{row['solve_ms_p50']:.2f} ms p90 {row['solve_ms_p90']:.2f} ms; reference p50 "
                  f"{row['reference_ms_p50']:.2f} ms; {row['ticks_per_s']:.3f} ticks/s of wall "
                  f"time; n_warm_resets {row['n_warm_resets']}; launches {launches}; base height "
                  f"{z.min():.4f}..{z.max():.4f} (reference {z_ref}); max g_norm "
                  f"{row['g_norm_max']:.3e} | {card}")
            if run == "stance":
                row["plant_step"] = plant_step_report(torch, mpc.model.flow_map, log, card,
                                                      f"closed loop {form} stance")

        # the first 3 ticks against the plain versions
        plain.runtime.reset()
        precord = _recording(plain.runtime, riccati, fkvel)
        run_dummy_sim(plain.runtime, plain.initial_state, 3 * 2 / 50.0, 50.0, 25.0,
                      flow=plain.model.flow_map)
        errs = []
        del plain.runtime.advance
        for k in range(3):
            kr, pr = kernel_record[k], precord[k]
            if pr["k1"] or pr["k2"]:
                raise AssertionError(f"closed loop {form}: the plain twin launched a kernel")
            for what in ("xs", "us"):
                a_, b_ = kr[what], pr[what]
                err = float(np.abs(a_ - b_).max())
                limit = SOLVE_TOL * max(1.0, float(np.abs(b_).max()))
                if not err <= limit:
                    raise AssertionError(f"closed loop {form} tick {k}: kernels and plain "
                                         f"versions disagree on {what}: {err:.3e} > {limit:.3e}")
                errs.append(err)
            if kr["stats"].step_size != pr["stats"].step_size:
                raise AssertionError(f"closed loop {form} tick {k}: kernels took step "
                                     f"{kr['stats'].step_size}, plain versions "
                                     f"{pr['stats'].step_size}")
        print(f"closed loop {form}: first 3 ticks vs plain versions max|dxs|, |dus| "
              f"{max(errs[0::2]):.3e}, {max(errs[1::2]):.3e} (limit {SOLVE_TOL} x max(1, "
              f"max|ref|)), the same steps")
        result["vs_plain_max_err"] = max(errs)
        out[form] = result
    return out


def _clone(tree):
    """Copies of the tensors of nested tuples / NamedTuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        parts = [_clone(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


class LaunchRecorder:
    """Wraps `module.name` (a kernel wrapper, looked up at call time by its
    dispatcher) to keep the inputs and outputs of its last launch under
    `key`, or under key(*args) when `key` is a function, and to count its
    launches by key. A graphed solve calls the wrapper once, while its
    capture records the launch, and then replays it without Python: under
    capture the recorder keeps copies of the launch's inputs and outputs
    that the graph refreshes at every replay, and a stamp and a count on the
    device that the graph advances with each replay. So `last()` gives each
    key's last launch that ran (eager, or a graph's last replay) and
    `counts()` every launch that ran, replays included; a graph captured and
    never replayed gives nothing. With keep=False it only counts (one
    one-element add on the device a launch, no copies): the recorder of a
    path whose timing matters."""

    def __init__(self, module, name: str, key, device, slots: int = 4096, keep: bool = True):
        import torch

        self.module, self.name = module, name
        self.orig = getattr(module, name)
        dev = torch.device(device)
        self.tick = torch.zeros((), dtype=torch.int64, device=dev)
        self.stamps = torch.zeros(slots, dtype=torch.int64, device=dev)
        self.counted = torch.zeros(slots, dtype=torch.int64, device=dev)
        self.keys: dict = {}      # key -> its slot in `counted`
        self.entries: list = []   # (key, args, kwargs, out); entry i's stamp is stamps[i]
        self.eager: dict = {}     # key -> the entry its eager launches overwrite

        def wrapper(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            k = key(*args) if callable(key) else key
            slot = self.keys.setdefault(k, len(self.keys))
            if not keep:
                self.counted[slot].add_(1)
                return out
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                i = len(self.entries)
                self.entries.append((k, _clone(args), kwargs, _clone(out)))
            else:
                i = self.eager.setdefault(k, len(self.entries))
                if i == len(self.entries):
                    self.entries.append(None)
                self.entries[i] = (k, args, kwargs, out)
            if i >= slots:
                raise AssertionError(f"LaunchRecorder {name}: more than {slots} launch sites")
            self.tick.add_(1)
            self.stamps[i].copy_(self.tick)
            self.counted[slot].add_(1)
            return out

        setattr(module, name, wrapper)

    def restore(self) -> None:
        setattr(self.module, self.name, self.orig)

    def last(self) -> dict:
        """{key: (args, kwargs, outputs)} of each key's last launch that ran."""
        stamps = self.stamps.cpu().tolist()
        best: dict = {}
        for i, entry in enumerate(self.entries):
            if entry is not None and stamps[i] > 0 and stamps[i] > best.get(entry[0], (0,))[0]:
                best[entry[0]] = (stamps[i], entry[1:])
        return {k: v for k, (_, v) in best.items()}

    def counts(self) -> dict:
        """{key: launches that ran}."""
        counted = self.counted.cpu().tolist()
        return {k: counted[slot] for k, slot in self.keys.items()}


TICK_PAIRS, TICK_CALLS = 5, 50   # the controller alone, graphed against eager


def first_tick_beside_capture(torch, rt, ctrl_cls, model, x0, alone_ms: float, what: str,
                              card: str) -> dict:
    """A new controller's first tick, its warm-up and capture, while a
    `MrtPipeline`'s solver thread captures its solve: the runtime's solve
    graphs dropped, the pipeline started from (0, x0), and the tick computed
    (the fallback, no policy) as soon as the solver thread's warm-up
    iteration has ended, i.e. when its capture begins. The controller's
    warm-up runs beside that capture; its own capture waits for it (one
    capture at a time in a process). Printed beside `alone_ms`, the first
    tick of a controller with no solver thread."""
    from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline

    rt.reset()
    rt.solve_fn.release()
    fresh = ctrl_cls(model, device="cuda")
    pipe = MrtPipeline(rt, nx=x0.shape[0], device="cuda")
    pipe.push_observation(0.0, x0, np.zeros(4))
    pipe.start()
    try:
        t_wait = time.perf_counter()
        while True:
            sets = list(rt.solve_fn.sets.values())
            if pipe.failed or (sets and sets[0].warmup_s is not None):
                break
            if time.perf_counter() - t_wait > 120.0:
                raise AssertionError(f"{what}: the solver thread did not warm up in 120 s")
            time.sleep(0.0002)
        capturing = bool(sets) and sets[0].capture_s is None
        c0 = time.perf_counter()
        tau = fresh.compute(0.0, x0, None).ff_effort
        tick_ms = (time.perf_counter() - c0) * 1e3
        while pipe.solve_count < 1 and not pipe.failed:
            if time.perf_counter() - t_wait > 120.0:
                raise AssertionError(f"{what}: no solve in 120 s")
            time.sleep(0.01)
    finally:
        pipe.stop(timeout=120.0)
    if pipe.failed:
        raise AssertionError(f"{what}: the solver failed ({pipe.error!r})")
    if not np.isfinite(tau).all():
        raise AssertionError(f"{what}: non-finite torque at the first tick")
    (entry, _), (solver_set,) = function_graph(fresh.graph), rt.solve_fn.sets.values()
    out = dict(first_tick_ms=tick_ms, first_tick_alone_ms=alone_ms,
               solver_capturing_at_tick=capturing, controller_warmup_s=entry.warmup_s,
               controller_capture_s=entry.capture_s, solver_warmup_s=solver_set.warmup_s,
               solver_capture_s=solver_set.capture_s)
    print(f"{what}: a new controller's first tick (warm-up and capture) beside the solver "
          f"thread's capture {tick_ms:.3f} ms (its warm-up {entry.warmup_s * 1e3:.3f} ms, "
          f"capture {entry.capture_s * 1e3:.3f} ms; the solver's capture "
          f"{'under way' if capturing else 'already ended'} at the tick: warm-up "
          f"{solver_set.warmup_s:.3f} s, capture {solver_set.capture_s:.3f} s); with no "
          f"solver thread {alone_ms:.3f} ms | {card}")
    return out


def mrt_phase(torch, riccati, fkvel, card: str) -> dict:
    """The MRT host runtime at full width: per formulation, a `MrtPipeline`
    whose solver thread solves on the card while a 500 Hz control loop in
    this thread, each tick, pushes an observation from a replay plant (the
    newest policy's state at t + dt), reads the policy through the native
    seqlock and computes torques with the formulation's controller (on its
    own CUDA stream) and with the native `control_tick`. The control clock
    is the wall clock. Whole-body for at least 5 s and 5 policies used by the
    control loop, centroidal for at least 2 s and 3. The controller is the
    card's default: its feed-forward a CUDA graph, captured by its first
    compute, on its own stream. Before the loop: the
    controller alone against its eager twin, TICK_PAIRS pairs of TICK_CALLS
    calls in turns, p50 and p99 each; its graph's device ms, capture
    seconds and memory; the device ms of its ticks alone (`DeviceTimer`);
    graphed against eager torques on the same observations and policies at
    GRAPH_TOL; one solve of the solver thread from a fixed observation
    holds its K1 against the plain version. The loop reads its controller's
    device ms per tick beside the solver thread. After it, the thread's last
    K1 and K2 launches are launched again (bit-identical) and held against
    plain. Last, a new controller's first tick (its warm-up and capture)
    beside a solver thread that is capturing: the runtime's graphs dropped,
    a new pipeline started, and the tick timed once the solver thread's
    warm-up iteration has ended, against the first tick of the loop's
    controller with no solver thread."""
    from wb_humanoid_mpc_tpu_torch import native
    from wb_humanoid_mpc_tpu_torch.core.config import load_task_config
    from wb_humanoid_mpc_tpu_torch.interface import (
        ASSETS,
        build_centroidal_mpc,
        build_wb_mpc,
        mpc_files,
    )
    from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline, PolicyObserver
    from wb_humanoid_mpc_tpu_torch.mpc.controller import (
        CentroidalMrtController,
        WBMrtController,
    )

    period = 0.002
    out = {}
    for form, build, ctrl_cls, seconds, min_solves in (
            ("wb", build_wb_mpc, WBMrtController, 5.0, 5),
            ("centroidal", build_centroidal_mpc, CentroidalMrtController, 2.0, 3)):
        files = mpc_files(ASSETS / "humanoid23", form)
        kw = dict(n_nodes=N_NODES)
        if form == "wb":
            kw["dt_override"] = load_task_config(files[1], "wb", 1, 1).sqp.dt
        mpc = build(*files, **kw, device="cuda")
        lay, n = mpc.model.layout, mpc.model.layout.n_joints
        x0 = np.asarray(mpc.initial_state, dtype=float)
        rt = mpc.runtime
        horizon = mpc.n_nodes * mpc.dt
        ctrl = ctrl_cls(mpc.model, device="cuda")
        # state rows of the joint angles; joint velocity references from the
        # state (whole-body) or from the input (centroidal)
        if form == "wb":
            q_off, qd_src, qd_off = 6, 0, 12 + n
        else:
            q_off, qd_src, qd_off = 12, 1, 12
        # the kernels' last launches in the solver thread, replays included
        # (the graphed solves are captured by the warm solve below)
        recorders = [LaunchRecorder(riccati, "riccati_rollout_cuda", "K1", "cuda"),
                     LaunchRecorder(fkvel, "flow_map_cuda", "K2", "cuda")]
        # warm: the first solve (its graphs' capture) and controller call
        # (its graph's capture) of a process are slow; then the controller
        # alone, with no solver thread beside it
        rt.advance(0.0, x0, np.zeros(4))
        warm_pol = rt.policy
        rt.reset()
        ctrls = {"own": ctrl, "eager": ctrl_cls(mpc.model, device="cuda", graphs=False)}
        first_tick_ms = {}
        for k, c in ctrls.items():
            c0 = time.perf_counter()
            c.compute(0.0, x0, None)
            first_tick_ms[k] = (time.perf_counter() - c0) * 1e3
        if ctrls["eager"].graph is not None or ctrl.graph is None:
            raise AssertionError(f"mrt {form}: the controller on the card is not graphed by "
                                 f"default, or graphs=False is")
        entry, ctrl_graph = function_graph(ctrl.graph)
        capture = dict(warmup_s=entry.warmup_s, capture_s=entry.capture_s,
                       pool_bytes=entry.pool_bytes)
        # graphed against eager on the same observations and policies
        rng = np.random.default_rng(11)
        tau_vs_eager = 0.0
        for t in (0.0, 0.013, 0.05, 0.2):
            x_obs = warm_pol.evaluate(t)[0] + 0.01 * rng.standard_normal(x0.shape)
            for pol in (None, warm_pol):
                got, ref = (torch.from_numpy(ctrls[k].compute(t, x_obs, pol).ff_effort)
                            for k in ("own", "eager"))
                tau_vs_eager = max(tau_vs_eager, scaled_err(
                    [got], [ref], GRAPH_TOL, f"mrt {form}: graphed vs eager torques at t = {t}"))
        alone = timed_pairs({k: (lambda c=ctrls[k]: c.compute(0.004, x0, warm_pol))
                             for k in ("own", "eager")}, TICK_PAIRS, TICK_CALLS)
        graph_ms = kernel_device_ms(ctrl_graph.replay, 20)
        timer = DeviceTimer(torch, ctrl.graph)
        try:
            for _ in range(TICK_CALLS):
                ctrl.compute(0.004, x0, warm_pol)
            alone_device_ms = float(np.percentile(timer.take(), 50))
        finally:
            timer.restore()
        torch.cuda.synchronize()
        print(f"mrt {form}: controller alone (no solver thread), graphed {alone['own']['p50']} "
              f"ms p50, {alone['own']['p99']} ms p99; eager {alone['eager']['p50']} ms p50, "
              f"{alone['eager']['p99']} ms p99 ({TICK_PAIRS} pairs of {TICK_CALLS} calls in "
              f"turns); a graphed tick's device work (input copies and replay, CUDA events on "
              f"its stream) p50 {alone_device_ms:.4f} ms; "
              f"its graph {graph_ms:.4f} ms on the device, captured in "
              f"{entry.capture_s:.3f} s (warm-up {entry.warmup_s:.3f} s), "
              f"{entry.pool_bytes / 2**20:.1f} MiB; max|graphed - eager| torques "
              f"{tau_vs_eager:.3e} (limit {GRAPH_TOL} x max(1, max|ref|)); its first tick "
              f"(warm-up and capture) {first_tick_ms['own']:.3f} ms | {card}")

        # the solver thread's K1 on a reproducible input: the one solve of a
        # fresh pipeline from the fixed observation (t = 0, x0)
        probe = MrtPipeline(rt, nx=x0.shape[0], device="cuda")
        probe.push_observation(0.0, x0, np.zeros(4))
        probe.start()
        try:
            t_probe = time.perf_counter()
            while probe.solve_count < 1 and not probe.failed:
                if time.perf_counter() - t_probe > 120.0:
                    raise AssertionError(f"mrt {form}: no solve from the fixed observation in "
                                         f"120 s")
                time.sleep(0.01)
        finally:
            probe.stop(timeout=120.0)
        if probe.failed:
            raise AssertionError(f"mrt {form}: the solver failed ({probe.error!r})")
        rt.reset()
        # the probe solve replayed the graphs: its last K1 launch, from the
        # graph's copies of its inputs and outputs
        args, kwargs, got = recorders[0].last()["K1"]
        torch.cuda.synchronize()
        e1_fixed, r1_fixed = k1_solver_err(
            got, riccati.riccati_rollout_plain(*args, **kwargs),
            f"mrt {form} K1 (solver thread, fixed observation)")

        def control_loop(pipe, c):
            """The 500 Hz loop beside pipe's solver thread with controller c
            (the pipeline started and stopped here)."""
            loop = dict(starts=[], work=[], ctrl_ms=[], ages=[], past=[], tau_err=0.0,
                        policies=set(), device_ms=[])
            x = x0.copy()
            timer = DeviceTimer(torch, c.graph)
            pipe.start()
            try:
                t_start = time.perf_counter()
                k = 0
                while True:
                    wait = t_start + k * period - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    s0 = time.perf_counter()
                    loop["starts"].append(s0)
                    t = s0 - t_start   # the control clock is the wall clock
                    pipe.push_observation(t, x, np.zeros(4))
                    pol = pipe.get_policy()
                    c0 = time.perf_counter()
                    action = c.compute(t, x, pol)
                    loop["ctrl_ms"].append((time.perf_counter() - c0) * 1e3)
                    loop["device_ms"] += timer.take()
                    q = x[q_off:q_off + n]
                    if pol is None:
                        qd = np.zeros(n)
                    else:
                        qd = (x[qd_off:qd_off + n] if qd_src == 0
                              else lay.joint_input(pol.evaluate(t)[1]))
                    tau = action.total_torque(q, qd)
                    if not np.isfinite(tau).all():
                        raise AssertionError(f"mrt {form}: non-finite torque at tick {k}")
                    if pol is not None:
                        loop["policies"].add(pol.t0)
                        tau_n = native.control_tick(
                            pol.xs, pol.us, pol.t0, pol.dt, t + c.lead, q_off, qd_src, qd_off,
                            np.arange(n), action.ff_effort, c.KP, c.KD, c.KP_FIXED, c.KD_FIXED,
                            q, qd)
                        loop["tau_err"] = max(loop["tau_err"], float(
                            np.abs(tau_n - tau).max() / max(1.0, float(np.abs(tau).max()))))
                        loop["ages"].append(t - pol.t0)
                        loop["past"].append(t + c.lead - pol.t0 > horizon)
                        x = np.asarray(pol.evaluate(t + period)[0], dtype=float)   # replay plant
                    loop["work"].append(time.perf_counter() - s0)
                    k += 1
                    elapsed = time.perf_counter() - t_start
                    if pipe.failed or (elapsed >= seconds and len(loop["policies"]) >= min_solves):
                        break
                    if elapsed > 120.0:
                        raise AssertionError(f"mrt {form}: {len(loop['policies'])} policies in "
                                             f"120 s")
            finally:
                pipe.stop(timeout=120.0)
                timer.restore()
            loop["wall"] = time.perf_counter() - t_start
            if pipe._thread is not None:
                raise AssertionError(f"mrt {form}: stop() did not join the solver thread")
            if pipe.failed:
                raise AssertionError(f"mrt {form}: the solver failed ({pipe.error!r})")
            periods = np.diff(loop["starts"]) * 1e3
            loop["summary"] = dict(
                tick_period_ms_p50=float(np.percentile(periods, 50)),
                tick_period_ms_p99=float(np.percentile(periods, 99)),
                tick_period_ms_max=float(periods.max()),
                overruns=int(sum(w > period for w in loop["work"])),
                controller_ms_p50=float(np.percentile(loop["ctrl_ms"], 50)),
                controller_ms_p99=float(np.percentile(loop["ctrl_ms"], 99)),
                controller_device_ms_p50=float(np.percentile(loop["device_ms"], 50)),
                controller_device_ms_p99=float(np.percentile(loop["device_ms"], 99)),
                policy_age_ms_p50=float(np.percentile(loop["ages"], 50)) * 1e3,
                policy_age_ms_max=float(max(loop["ages"])) * 1e3, ticks=len(loop["starts"]))
            return loop

        record = _recording(rt, riccati, fkvel)
        pipe = MrtPipeline(rt, nx=x0.shape[0], device="cuda")
        observer = PolicyObserver(pipe)
        for mod in (riccati, fkvel):
            mod.reset_launches()
        try:
            loop = control_loop(pipe, ctrl)
        finally:
            for r in recorders:
                r.restore()
            del rt.advance   # the recording wrapper
        torch.cuda.synchronize()
        launches = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES}
        wall, tau_err, ages, past = loop["wall"], loop["tau_err"], loop["ages"], loop["past"]
        if len(loop["policies"]) < 3:
            raise AssertionError(f"mrt {form}: {len(loop['policies'])} policies seen by the "
                                 f"control loop")
        if "lib" not in native._state or pipe._pol_buf._lib is not native._state["lib"]:
            raise AssertionError(f"mrt {form}: the seqlock buffers are not the native library's")
        pol, pol_obs = pipe.get_policy(), observer.get_policy()
        if pol_obs is None or not (np.array_equal(pol.xs, pol_obs.xs)
                                   and np.array_equal(pol.us, pol_obs.us) and pol.t0 == pol_obs.t0):
            raise AssertionError(f"mrt {form}: the observer's policy is not the pipeline's")
        if not tau_err <= 1e-9:
            raise AssertionError(f"mrt {form}: native control_tick vs the controller's torques "
                                 f"{tau_err:.3e}")
        n_it = sum(r["stats"].iterations for r in record)
        k1, k2 = sum(r["k1"] for r in record), sum(r["k2"] for r in record)
        if (launches["K1"], launches["K2"]) != (k1, k2):
            raise AssertionError(f"mrt {form}: launches outside the solves {launches}")
        if k1 != n_it:
            raise AssertionError(f"mrt {form}: K1 launched {k1} times in {n_it} SQP iterations")
        lo, hi = (6 * n_it, 9 * n_it) if form == "wb" else (0, 0)
        if not lo <= k2 <= hi:
            raise AssertionError(f"mrt {form}: K2 launched {k2} times in {n_it} SQP iterations")
        # the solver thread's last launches in the loop: launched again from
        # this thread (bit-identical), and against the plain versions on the
        # same inputs (which depend on the loop's wall-clock timing; the
        # fixed observation's K1 above is the reproducible check)
        same_bits = {}
        captured = {**recorders[0].last(), **recorders[1].last()}
        args, kwargs, got = captured["K1"]
        again = riccati.riccati_rollout_cuda(*args, **kwargs)
        same_bits["K1"] = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same_bits["K1"]:
            raise AssertionError(f"mrt {form}: K1 launched again on the solver thread's last "
                                 f"inputs gives other bits")
        e1, r1 = k1_solver_err(got, riccati.riccati_rollout_plain(*args, **kwargs),
                               f"mrt {form} K1 (solver thread, last launch)")
        e2 = r2 = None
        if form == "wb":
            args, kwargs, got = captured["K2"]
            same_bits["K2"] = torch.equal(got, fkvel.flow_map_cuda(*args, **kwargs))
            if not same_bits["K2"]:
                raise AssertionError(f"mrt {form}: K2 launched again on the solver thread's "
                                     f"last inputs gives other bits")
            e2 = flow_vs_plain(*args, got, what=f"mrt {form} K2")
            ref2 = args[0].flow_map_batch(None, args[1].double(), args[2].double(),
                                          backend="plain")
            r2 = float(((got.double() - ref2).abs()
                        / (FLOW_TOL["atol"] + FLOW_TOL["rtol"] * ref2.abs())).max())
        solve_ms = np.array([r["stats"].solve_time for r in record]) * 1e3
        row = dict(solves=pipe.solve_count, policies_seen=len(loop["policies"]), wall_s=wall,
                   **loop["summary"],
                   controller_alone_ms_p50=alone["own"]["median_p50"],
                   controller_alone_device_ms_p50=alone_device_ms,
                   controller_alone=alone, controller_graph_device_ms=graph_ms,
                   controller_capture=capture, controller_vs_eager=tau_vs_eager,
                   controller_first_tick_alone_ms=first_tick_ms["own"],
                   gil_switch_interval_s=sys.getswitchinterval(),
                   past_horizon_share=float(np.mean(past)), horizon_s=horizon,
                   solve_ms_p50=float(np.percentile(solve_ms, 50)),
                   sqp_iterations=n_it, k1_per_iteration=k1 / n_it,
                   k2_per_iteration=k2 / n_it, k1_fixed_vs_plain=e1_fixed,
                   k1_fixed_share_of_limit=r1_fixed, k1_last_vs_plain=e1,
                   k1_last_share_of_limit=r1, k2_last_vs_plain=e2, k2_last_share_of_limit=r2,
                   native_vs_controller=tau_err, relaunch_same_bits=same_bits,
                   launches=launches)
        out[form] = row
        print(f"mrt {form} (graphed solves, captured by the warm solve in this thread and "
              f"replayed by the solver thread; their graphs hold the K1/K2 recorders' copies, "
              f"whose cost the graphs phase prints): {row['solves']} solves (p50 "
              f"{row['solve_ms_p50']:.2f} ms), "
              f"{row['policies_seen']} policies seen by the control loop, "
              f"{row['ticks']} control ticks in {wall:.2f} s; tick period p50 "
              f"{row['tick_period_ms_p50']:.3f} ms p99 {row['tick_period_ms_p99']:.3f} ms max "
              f"{row['tick_period_ms_max']:.3f} ms; {row['overruns']} ticks over 2 ms; "
              f"controller p50 {row['controller_ms_p50']:.3f} ms p99 "
              f"{row['controller_ms_p99']:.3f} ms, its device work a tick p50 "
              f"{row['controller_device_ms_p50']:.3f} ms (alone, no solver thread: p50 "
              f"{row['controller_alone_ms_p50']:.3f} ms, device "
              f"{row['controller_alone_device_ms_p50']:.3f} ms; GIL switch interval "
              f"{sys.getswitchinterval() * 1e3:g} ms); policy age p50 {row['policy_age_ms_p50']:.1f} "
              f"ms max {row['policy_age_ms_max']:.1f} ms; ticks past the {horizon:.3f} s horizon "
              f"{100 * row['past_horizon_share']:.2f} %; per SQP iteration in the solver thread "
              f"K1 {row['k1_per_iteration']:.2f} K2 {row['k2_per_iteration']:.2f}; solver "
              f"thread's K1 vs plain from the fixed observation {e1_fixed:.3e} "
              f"({r1_fixed:.3f} of its limit), at its last launch {e1:.3e} ({r1:.3f} of "
              f"its limit); its last K2 vs plain "
              f"{'-' if e2 is None else f'{e2:.3e} ({r2:.3f} of its limit)'}; the last "
              f"launches again from the main thread bit-identical {same_bits}; "
              f"native control_tick vs controller {tau_err:.1e} | {card}")
        row["first_tick_beside_capture"] = first_tick_beside_capture(
            torch, rt, ctrl_cls, mpc.model, x0, first_tick_ms["own"], f"mrt {form}", card)
    return out


def batched_phase(torch, riccati, fkvel, card: str, rows: dict) -> dict:
    """The batched solve (`make_batched_solver`) at full width, one SQP
    iteration: at B = 8 per instance against 8 unbatched solves and the
    kernel run against the plain run; then `batched_throughput` at B = 1, 8,
    64 and the largest B that fits by the peak memory of B = 8 and 64 (at
    most 256), K1 launched once per batched iteration, K2's launches by row
    count counted on the device (count-only, so the timing holds no
    copies); K1's device time at B = 8, 64 and the largest B against its
    bound; K2's last launch at each of those row counts at B = 64 and the
    largest B, in a batched solve apart from the sweep, against its plain
    version, timed beside its bound. Adds K1's and K2's batched rows."""
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_inputs, batched_throughput
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    pb = build_wb_problem(ASSETS / "humanoid23", N_NODES, device="cuda", dtype=torch.float32)
    dev = pb.x0.device
    cfg = SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    pcfg = dataclasses.replace(cfg, rollout_backend="plain", flow_backend="plain")
    solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
    plain = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, pcfg, device="cuda")
    single = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
    B = 8
    x0s, traj, params, lam = batched_inputs(pb, B, seed=0)
    for mod in (riccati, fkvel):
        mod.reset_launches()
    got = solve(0.0, x0s, traj, params, lam)
    torch.cuda.synchronize()
    k1, k2 = riccati.LAUNCHES, fkvel.LAUNCHES
    if k1 != 1 or not 6 <= k2 <= 9:
        raise AssertionError(f"batched B={B}: K1 {k1} and K2 {k2} launches in one iteration")
    steps = got.step_size.tolist()
    err_single = 0.0
    for i in range(B):
        s1 = single(0.0, x0s[i], Trajectory(xs=traj.xs[i], us=traj.us[i]),
                    type(params)(*(a[i] for a in params)), lam[i])
        err_single = max(err_single, scaled_err(
            [got.traj.xs[i], got.traj.us[i]], [s1.traj.xs, s1.traj.us], SOLVE_TOL,
            f"batched B={B} instance {i} vs its unbatched solve"))
        if float(s1.step_size) != steps[i]:
            raise AssertionError(f"batched B={B} instance {i}: step {steps[i]} batched, "
                                 f"{float(s1.step_size)} unbatched")
    ref = plain(0.0, x0s, traj, params, lam)
    err_plain = scaled_err([got.traj.xs, got.traj.us], [ref.traj.xs, ref.traj.us], SOLVE_TOL,
                           f"batched B={B} kernels vs plain")
    if ref.step_size.tolist() != steps:
        raise AssertionError(f"batched B={B}: kernels took steps {steps}, plain versions "
                             f"{ref.step_size.tolist()}")
    print(f"batched B={B}: steps {steps}; vs 8 unbatched solves max|d| {err_single:.3e}, "
          f"kernels vs plain max|d| {err_plain:.3e} (limit {SOLVE_TOL} x max(1, max|ref|)); "
          f"K1 {k1}, K2 {k2} launches in one batched iteration; K2 rows per launch "
          f"{B * N_NODES} (RK4 tail), {2 * B * N_NODES} (top-2 sweep)")

    def rows_of(model, xs, us):
        return xs.shape[0]

    def sweep(batch):
        for mod in (riccati, fkvel):
            mod.reset_launches()
        n_rounds = 5 if batch <= 8 else 3
        # count-only: the sweep's timing carries no copies
        rec = LaunchRecorder(fkvel, "flow_map_cuda", rows_of, "cuda", keep=False)
        try:
            r = batched_throughput(batch, N_NODES, n_rounds=n_rounds, device="cuda")
        finally:
            rec.restore()
        by_rows = rec.counts()
        n_it = n_rounds + 1
        if riccati.LAUNCHES != n_it or not 6 * n_it <= fkvel.LAUNCHES <= 9 * n_it:
            raise AssertionError(f"batched B={batch}: K1 {riccati.LAUNCHES}, K2 "
                                 f"{fkvel.LAUNCHES} launches in {n_it} batched iterations")
        if sum(by_rows.values()) != fkvel.LAUNCHES:
            raise AssertionError(f"batched B={batch}: K2 launches by rows {by_rows}, "
                                 f"{fkvel.LAUNCHES} counted")
        if not r["finite"]:
            raise AssertionError(f"batched B={batch}: non-finite cost")
        r.update(k1_launches=riccati.LAUNCHES, k2_launches=fkvel.LAUNCHES, iterations=n_it,
                 k2_launches_by_rows=dict(sorted(by_rows.items())))
        print(f"batched B={batch} (graphed): {r['instances_per_s']:.2f} instances/s, "
              f"{r['sqp_iterations_per_s']:.2f} SQP it/s ({r['round_time_s'] * 1e3:.2f} ms a "
              f"batched iteration); peak device memory {r['peak_memory_bytes'] / 2**20:.0f} MiB; "
              f"launches in {n_it} iterations K1 {riccati.LAUNCHES} K2 {fkvel.LAUNCHES} (by "
              f"rows a launch {r['k2_launches_by_rows']}) | {card}")
        return r

    report = {b: sweep(b) for b in (1, 8, 64)}
    total = torch.cuda.get_device_properties(0).total_memory
    per_instance = (report[64]["peak_memory_bytes"] - report[8]["peak_memory_bytes"]) / 56
    base = report[8]["peak_memory_bytes"] - 8 * per_instance
    fits = int((0.8 * total - base) // per_instance)
    b_max = min(256, fits)
    print(f"batched: peak memory {base / 2**20:.0f} MiB + {per_instance / 2**20:.2f} MiB an "
          f"instance; 80 % of the card's {total / 2**30:.1f} GiB fits B = {fits}, so the sweep "
          f"ends at B = {b_max}")
    if b_max not in report:
        report[b_max] = sweep(b_max)

    # K1 alone at the batched solve's shape, (B, 28, 58, 21) f32
    def lq_batch(seed, batch):
        r = np.random.default_rng(seed)
        parts = [riccati.random_lq_data(r, N_NODES, 58, 21) for _ in range(batch)]
        return [torch.as_tensor(np.stack([p_[k] for p_ in parts]), device=dev) for k in
                ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]

    k1_rows = {}
    for batch in sorted({8, 64, b_max}):
        args = lq_batch(100 + batch, batch)
        out_k = riccati.riccati_rollout_cuda(*args, reg=1e-8)
        out_p = riccati.riccati_rollout_plain(*args, reg=1e-8)
        torch.cuda.synchronize()
        err = max_err(out_k, out_p, what=f"K1 batch={batch}", **K1_TOL)
        t_dev = kernel_device_ms(lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8), 10)
        t_p = cuda_time_ms(lambda: riccati.riccati_rollout_plain(*args, reg=1e-8), 3, warmup=1)
        nbytes, ops = riccati_work(batch, N_NODES, 58, 21, 4)
        b_ms, b_by = bound_ms(nbytes, ops)
        waves = -(-batch // N_SMS)
        sm_ms = waves * riccati_work(1, N_NODES, 58, 21, 4)[1] / (PEAK_F32_FLOPS / N_SMS) * 1e3
        k1_rows[batch] = dict(name=f"riccati_rollout batch={batch}", route="cuda",
                              source="wb_humanoid_mpc_tpu_torch/csrc/riccati.cu",
                              replaces="wb_humanoid_mpc_tpu/ops/riccati.py:129",
                              launches=report[batch]["k1_launches"], max_abs_err=err, ms=t_dev,
                              plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"K1 riccati (28,58,21) batch={batch}: max|kernel-plain| {err:.3e}; kernel "
              f"{t_dev * 1e3:.1f} us on the device ({t_dev * 1e3 / batch:.2f} us an instance); "
              f"plain {t_p * 1e3:.1f} us per call; bound {b_ms * 1e3:.3f} us ({b_by}), "
              f"{100 * b_ms / t_dev:.3f} % of it; one-SM floor x {waves} wave(s) "
              f"{sm_ms * 1e3:.1f} us | {card}")
    rows["riccati_batched"] = [k1_rows[b] for b in sorted(k1_rows)]

    # K2 at the batched solve's row counts, B = 64 and the largest B: the
    # last launch of each row count in a batched solve of its own (its first
    # call, whose eager warm-up runs the lower ladder, and one replay), whose
    # recorder keeps copies of the launches, against the plain version on
    # the same inputs
    def last_k2_launches(batch):
        rec = LaunchRecorder(fkvel, "flow_map_cuda", rows_of, "cuda")
        solve_b = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
        x0s_b, traj_b, params_b, lam_b = batched_inputs(pb, batch, seed=0)
        try:
            first_b = solve_b(0.0, x0s_b, traj_b, params_b, lam_b)
        finally:
            rec.restore()
        solve_b(0.0, x0s_b, first_b.traj, params_b, first_b.lam)
        torch.cuda.synchronize()
        caps = rec.last()
        if set(caps) != set(report[batch]["k2_launches_by_rows"]):
            raise AssertionError(f"batched B={batch}: K2 row counts {sorted(caps)}, in the "
                                 f"sweep {sorted(report[batch]['k2_launches_by_rows'])}")
        return caps

    k2_rows = []
    for batch in sorted({64, b_max}):
        for n_rows, (args, kwargs, got) in sorted(last_k2_launches(batch).items()):
            model_, xs, us = args
            err = flow_vs_plain(*args, got, what=f"K2 batch={batch} rows={n_rows}")
            t_dev = kernel_device_ms(lambda: fkvel.flow_map_cuda(*args, **kwargs), 20)
            t_p = cuda_time_ms(lambda: model_.flow_map_batch(None, xs, us, backend="plain"), 3,
                               warmup=1)
            nbytes, ops = fkvel_flow_work(n_rows, model_.robot.n_joints,
                                          len(model_.contact_frames), xs.element_size())
            b_ms, b_by = bound_ms(nbytes, ops)
            launches = report[batch]["k2_launches_by_rows"][n_rows]
            k2_rows.append(dict(name=f"fkvel flow batch={batch} rows={n_rows}", route="cuda",
                                source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                                replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                                launches=launches, max_abs_err=err, ms=t_dev, plain_ms=t_p,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
            print(f"K2 flow variant batch={batch} rows={n_rows} (the last launch of that size "
                  f"in a solve apart from the sweep; {launches} launches of it in the sweep's "
                  f"{report[batch]['iterations']} iterations): max|kernel-plain float64| "
                  f"{err:.3e} (atol {FLOW_TOL['atol']} rtol {FLOW_TOL['rtol']}); kernel {t_dev * 1e3:.2f} us on the device; plain "
                  f"{t_p * 1e3:.1f} us per call; bound {b_ms * 1e3:.4f} us ({b_by}: "
                  f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} MFLOP), {100 * b_ms / t_dev:.2f} % "
                  f"of it | {card}")
    rows["fkvel_batched"] = k2_rows
    return {"vs_unbatched_max_err": err_single, "vs_plain_max_err": err_plain, "steps_b8": steps,
            "sweep": {b: {k: r[k] for k in ("instances_per_s", "sqp_iterations_per_s",
                                             "round_time_s", "peak_memory_bytes",
                                             "k1_launches", "k2_launches",
                                             "k2_launches_by_rows", "iterations")}
                      for b, r in report.items()},
            "fits": fits, "b_max": b_max}


SHARDED_MESHES = (("1x1", 1, 1, "nccl"), ("1x4", 1, 4, "gloo"), ("2x4", 2, 4, "gloo"))
SHARDED_ITERS = 2
SHARDED_GATE = {"float32": 2e-2, "float64": 1e-4}   # max |dxs|: `dryrun_multichip`'s gates
# and a tighter limit, x max(1, max|ref|): on an H100 80GB HBM3 (700 W) every
# mesh read 1.5e-6 - 3.5e-6 (f32) and 5.5e-10 - 6.2e-10 (f64), see PERF.md
SHARDED_LIMIT = {"float32": 1e-4, "float64": 1e-8}
# K2 launches of one sharded SQP iteration on every rank (sensitivity "node"):
# the LQ's RK4 tail (k2..k4), the 8-step filter sweep's rollout and the final
# merit's rollout, 3 stages each through `flow_batch` (k1 comes with the
# node terms, `ocp.fused_node`)
K2_PER_SHARDED_ITERATION = 3 + 3 + 3
# the collectives of one sharded SQP iteration on every rank, and at the end
SHARDED_COLLECTIVES = {"all_gather": 6, "all_reduce": 5}
SHARDED_FINAL_GATHERS = 2
SHARDED_PAIRS = 4   # graphed and eager solves in turns, f32


def sharded_rank(cases) -> list:
    """One rank of the `sharded` phase: `dryrun.sharded_sqp_case` for each
    case, K2's last launch at each row count that a graph recorded kept
    (refreshed by every replay); rank (0, 0) returns those launches' inputs
    and outputs as numpy, for the parent to hold against the plain
    version."""
    import torch

    from wb_humanoid_mpc_tpu_torch.ops import fkvel
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import sharded_sqp_case

    def rows_in_a_graph(model, xs, us):
        return xs.shape[0] if torch.cuda.is_current_stream_capturing() else None

    out = []
    for case in cases:
        rec = LaunchRecorder(fkvel, "flow_map_cuda", rows_in_a_graph, case["device"])
        try:
            r = sharded_sqp_case(**case)
        finally:
            rec.restore()
        caps = rec.last()
        r["k2_last"] = {} if r["coords"] != (0, 0) else {
            rows: ([a.cpu().numpy() for a in args[1:]], got.cpu().numpy())
            for rows, (args, _, got) in caps.items() if rows is not None}
        out.append(r)
    return out


def _sharded_checks(outs: list, what: str, backend: str, B: int, ref) -> dict:
    """Every rank's graphed solve and its eager twin from one mesh and dtype:
    the same whole solution on every rank, graphed against eager at
    GRAPH_TOL, both against `make_batched_solver` (`ref`: xs, steps) at
    SHARDED_GATE and SHARDED_LIMIT with the same steps, K2 and the
    collectives per iteration under replay, the graphs of the backend's cut.
    Returns the readings."""
    o = next(r for r in outs if r["coords"] == (0, 0))
    dt = o["xs"].dtype.name
    n_gr = 9 + 2 if backend == "gloo" else 1 + 1    # graphs: one a part, or one a program
    n_eager = (sum(SHARDED_COLLECTIVES.values()) + SHARDED_FINAL_GATHERS
               if backend == "gloo" else 0)
    want_coll = {c: n * SHARDED_ITERS + SHARDED_FINAL_GATHERS * (c == "all_gather")
                 for c, n in SHARDED_COLLECTIVES.items()}
    graph_err = 0.0
    for r in outs:
        where = f"{what}: rank {r['coords']}"
        for key in ("xs", "us", "cost", "step_size"):
            if not np.array_equal(r[key], o[key]):
                raise AssertionError(f"{where} returned another {key}")
        if r["k2_launches"] != K2_PER_SHARDED_ITERATION * SHARDED_ITERS:
            raise AssertionError(f"{where} launched K2 {r['k2_launches']} times in "
                                 f"{SHARDED_ITERS} iterations, the plan says "
                                 f"{K2_PER_SHARDED_ITERATION} an iteration")
        if r["collectives"] != want_coll:
            raise AssertionError(f"{where} ran the collectives {r['collectives']}, the plan "
                                 f"says {want_coll}")
        g = r["graphed"]
        if g is None or g["graphs"] != n_gr or g["eager_collectives"] != n_eager:
            raise AssertionError(f"{where}: graphs {g}, {backend} cuts into {n_gr} graphs with "
                                 f"{n_eager} collectives between them")
        for key in ("xs", "us", "cost", "g_norm", "defect_norm"):
            a, b = r[key], r["eager"][key]
            err = float(np.abs(a.astype(np.float64) - b).max())
            if not err <= GRAPH_TOL * max(1.0, float(np.abs(b).max())):
                raise AssertionError(f"{where}: graphed {key} differs from eager by {err:.3e}")
            graph_err = max(graph_err, err)
        if not np.array_equal(r["step_size"], r["eager"]["step_size"]):
            raise AssertionError(f"{where}: graphed steps {r['step_size']}, eager "
                                 f"{r['eager']['step_size']}")
    if not (np.isfinite(o["xs"]).all() and np.isfinite(o["cost"]).all()):
        raise AssertionError(f"{what}: non-finite result")
    ref_xs, ref_steps = ref
    limit = SHARDED_LIMIT[dt] * max(1.0, float(np.abs(ref_xs).max()))
    errs = {}
    for side, sol in (("graphed", o), ("eager", o["eager"])):
        errs[side] = float(np.abs(sol["xs"] - ref_xs).max())
        if not errs[side] < min(SHARDED_GATE[dt], limit):
            raise AssertionError(f"{what} {side}: max |dxs| vs make_batched_solver "
                                 f"{errs[side]:.3e}, gate {SHARDED_GATE[dt]}, limit {limit:.3e}")
        if not np.array_equal(sol["step_size"], ref_steps):
            raise AssertionError(f"{what} {side}: steps {sol['step_size']}, batched {ref_steps}")
    coll = {c: (n - SHARDED_FINAL_GATHERS * (c == "all_gather")) / SHARDED_ITERS
            for c, n in o["collectives"].items()}
    out = dict(backend=backend, ranks=len(outs), batch=B, max_abs_dxs=errs["graphed"],
               max_abs_dxs_eager=errs["eager"], dxs_limit=limit, graphed_minus_eager=graph_err,
               steps=o["step_size"].tolist(), k2_per_rank=o["k2_launches"],
               collectives_per_iteration=coll, graphs=o["graphed"]["graphs"],
               segments=o["graphed"]["segments"],
               eager_collectives=o["graphed"]["eager_collectives"],
               capture_s=[r["graphed"]["capture_s"] for r in outs],
               warmup_s=[r["graphed"]["warmup_s"] for r in outs],
               pool_bytes=[r["graphed"]["pool_bytes"] for r in outs],
               first_solve_s=max(r["first_s"] for r in outs))
    if o["ms_per_iteration"] is not None:
        # each pair on the slowest rank
        for side in ("graphed", "eager"):
            per_pair = [max(r["ms_per_iteration"][side][i] for r in outs)
                        for i in range(SHARDED_PAIRS)]
            out[f"ms_per_iteration_{side}"] = per_pair
            out[f"ms_per_iteration_{side}_median"] = float(np.median(per_pair))
    return out


def sharded_phase(torch, fkvel, card: str, rows: dict, device: str = "cuda") -> dict:
    """The 2-D (batch x horizon) sharded SQP, the port's `dryrun_multichip`:
    humanoid23 at N = 28, the walking schedule, B = 2 n_dp instances, 2 SQP
    iterations, f32 and f64, on the meshes of SHARDED_MESHES (`nccl` for the
    single rank; `gloo` for several ranks on the one card, as NCCL refuses
    two ranks on one GPU), as CUDA graphs (`make_sharded_sqp_solver`'s
    default: on `gloo` one graph a part with the collectives between the
    replays, on `nccl` one graph an iteration with its collectives inside)
    and by the eager twin. Every rank's whole solution graphed against
    eager (GRAPH_TOL) and both against `make_batched_solver` on the card
    (SHARDED_GATE and the tighter SHARDED_LIMIT, the same steps), K2's
    launches and the collectives per rank per iteration under replay
    against the plan, the graphs, capture seconds and capture memory of
    each rank, the wall ms of an iteration graphed and eager in
    SHARDED_PAIRS pairs (f32, the slowest rank of each); K2's last launch
    in a graph at each of the path's row counts on the 1x1 and 2x4 meshes
    against its plain version. Adds K2's sharded rows."""
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, load_wb_model
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import walking_problem
    from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig

    model = load_wb_model(ASSETS / "humanoid23")[1]
    refs = {}
    for B in sorted({2 * n_dp for _, n_dp, _, _ in SHARDED_MESHES}):
        for dt in SHARDED_GATE:
            pb, *inputs = walking_problem("humanoid23", N_NODES, B, device=device,
                                          dtype=getattr(torch, dt))
            cfg = SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt, sqp_iterations=SHARDED_ITERS)
            sol = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg,
                                      device=device)(0.0, *inputs)
            refs[(B, dt)] = (sol.traj.xs.cpu().numpy(), sol.step_size.cpu().numpy())

    report, k2_rows = {}, []
    for label, n_dp, n_h, backend in SHARDED_MESHES:
        world, B = n_dp * n_h, 2 * n_dp
        cases = [dict(robot="humanoid23", n_nodes=N_NODES, batch=B, n_dp=n_dp, n_h=n_h,
                      backend=backend, device=device, dtype=dt, iterations=SHARDED_ITERS,
                      twin=True, timed_pairs=SHARDED_PAIRS if dt == "float32" else 0)
                 for dt in SHARDED_GATE]
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_rank, world, backend, device, cases, timeout_s=900.0)
        wall = time.perf_counter() - t0
        for k, dt in enumerate(SHARDED_GATE):
            outs = [r[k] for r in ranks]
            o = next(r for r in outs if r["coords"] == (0, 0))
            what = f"sharded {label} ({backend}) {dt}"
            rep = report[f"{label} {dt}"] = _sharded_checks(outs, what, backend, B,
                                                            refs[(B, dt)])
            rep["spawn_and_run_s"] = wall
            timing = ("" if "ms_per_iteration_graphed" not in rep else
                      f"; ms per sharded SQP iteration (slowest rank, {SHARDED_PAIRS} pairs in "
                      f"turns) graphed {rep['ms_per_iteration_graphed']} eager "
                      f"{rep['ms_per_iteration_eager']}")
            print(f"sharded {label} {backend} {dt}: {world} rank(s), B = {B}; graphed - eager "
                  f"{rep['graphed_minus_eager']:.3e}; max|dxs| vs make_batched_solver graphed "
                  f"{rep['max_abs_dxs']:.3e} eager {rep['max_abs_dxs_eager']:.3e} (gate "
                  f"{SHARDED_GATE[dt]}, limit {rep['dxs_limit']:.3e}); steps {rep['steps']} "
                  f"(batched the same); K2 {o['k2_launches']} launches on every rank in "
                  f"{SHARDED_ITERS} iterations; collectives per iteration on each rank "
                  f"{rep['collectives_per_iteration']} (+{SHARDED_FINAL_GATHERS} all_gather at "
                  f"the end); {rep['graphs']} graphs ({rep['segments']}), "
                  f"{rep['eager_collectives']} collectives between replays; capture s per "
                  f"rank {rep['capture_s']}, pool bytes {rep['pool_bytes']}; first solve "
                  f"{rep['first_solve_s']:.2f} s{timing}; spawn + run {wall:.1f} s | {card}")
            if dt != "float32" or label not in ("1x1", "2x4"):
                continue
            # K2 at this mesh's row counts: a replay's last launch of each size
            for n_rows, (args, got) in sorted(o["k2_last"].items()):
                xs, us = (torch.as_tensor(a, device=device) for a in args)
                got = torch.as_tensor(got, device=device)
                err = flow_vs_plain(model, xs, us, got, what=f"K2 sharded {label} "
                                    f"rows={n_rows}")
                t_dev = kernel_device_ms(lambda: fkvel.flow_map_cuda(model, xs, us), 20)
                t_p = cuda_time_ms(lambda: model.flow_map_batch(None, xs, us, backend="plain"),
                                   3, warmup=1)
                nbytes, ops = fkvel_flow_work(n_rows, model.robot.n_joints,
                                              len(model.contact_frames), xs.element_size())
                b_ms, b_by = bound_ms(nbytes, ops)
                launches = o["flow_batch_calls"][n_rows]
                k2_rows.append(dict(name=f"fkvel flow sharded {label} rows={n_rows}",
                                    route="cuda",
                                    source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                                    replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                                    launches=launches, max_abs_err=err, ms=t_dev, plain_ms=t_p,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
                print(f"K2 flow variant sharded {label} rows={n_rows} (rank 0's last launch of "
                      f"that "
                      f"size in a graph's replay, {launches} of its launches in the graphed "
                      f"solve): max|kernel-plain| {err:.3e}; kernel "
                      f"{t_dev * 1e3:.2f} us on the device; plain {t_p * 1e3:.1f} us per call; "
                      f"bound {b_ms * 1e3:.4f} us ({b_by}), {100 * b_ms / t_dev:.2f} % of it "
                      f"| {card}")
    if not k2_rows:
        raise AssertionError("sharded: no K2 launch was kept")
    rows["fkvel_sharded"] = k2_rows
    return report


GRAPH_PAIRS = 10
GRAPH_EAGER_SOLVES = (4, 3)      # (back to back, synced) eager solves in a pair's half
GRAPH_GRAPHED_SOLVES = (20, 5)   # the same for the graphed solve


def _rate_and_p50(torch, solve, pb, traj, lam, n_sus: int, n_lat: int):
    """(sustained it/s of n_sus warm-started solves back to back with one
    sync, p50 ms of n_lat synced solves, the last solution)."""
    t0 = time.perf_counter()
    for _ in range(n_sus):
        sol = solve(0.0, pb.x0, traj, pb.params, lam)
        traj, lam = sol.traj, sol.lam
    torch.cuda.synchronize()
    rate = n_sus / (time.perf_counter() - t0)
    lat = []
    for _ in range(n_lat):
        t1 = time.perf_counter()
        sol = solve(0.0, pb.x0, traj, pb.params, lam)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
        traj, lam = sol.traj, sol.lam
    return rate, float(np.percentile(lat, 50)), sol


def graph_device_ms(gs, inputs) -> dict:
    """Device ms of one replay of each graph of the graph set gs, each timed
    from the buffers loaded with inputs (t0, x0, traj, params, lam): every
    replay of C takes the step again and moves the trajectory, so without
    the load a graph would be timed on a state that earlier replays left."""
    out = {}
    for name, graph in gs.graphs.items():
        gs.load(*inputs)
        out[name] = kernel_device_ms(graph.replay, 10)
    return out


def timed_pairs(calls: dict, n_pairs: int, n_calls: int) -> dict:
    """Host ms of the calls of the two sides of `calls` ({side: fn}, each
    call synchronous) in n_pairs pairs of n_calls calls, in turns (the first
    side first in even pairs): {side: {"p50": [a pair's], "p99": [a pair's],
    "median_p50": ...}}."""
    sides = list(calls)
    out = {side: dict(p50=[], p99=[]) for side in sides}
    for i in range(n_pairs):
        for side in (sides if i % 2 == 0 else sides[::-1]):
            ms = []
            for _ in range(n_calls):
                t0 = time.perf_counter()
                calls[side]()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[side]["p50"].append(float(np.percentile(ms, 50)))
            out[side]["p99"].append(float(np.percentile(ms, 99)))
    for side in sides:
        out[side]["median_p50"] = float(np.median(out[side]["p50"]))
    return out


def function_graph(graphed) -> tuple:
    """(the one entry, its one CUDA graph) of a `GraphedFunction` called at
    one shape."""
    (entry,) = graphed.entries.values()
    return entry, entry.graphs[entry.pieces[0].name]


class DeviceTimer:
    """Wraps `run` of a `GraphedFunction` to record CUDA events on the
    current stream around the device work each run enqueues (its input
    copies and its replay): `take()`, once the caller has waited for that
    stream, gives the ms of each run since the last take."""

    def __init__(self, torch, graphed):
        self.graphed, self.pending = graphed, []
        orig = graphed.run

        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = orig(*args, **kwargs)
            end.record()
            self.pending.append((start, end))
            return out

        graphed.run = run

    def take(self) -> list:
        ms = [start.elapsed_time(end) for start, end in self.pending]
        self.pending.clear()
        return ms

    def restore(self) -> None:
        del self.graphed.run


PLANT_PAIRS, PLANT_STEPS = 5, 20


def plant_step_report(torch, flow, log, card: str, what: str) -> dict:
    """The dummy plant's RK4 step (`sim/dummy.py::PlantStep`, f32, 50 Hz),
    as the dummy sim takes it on the card (a CUDA graph) against its eager
    twin (`graphs=False`): at the (t, x, u) of every tick of log, held at
    GRAPH_TOL x max(1, max|ref|) (the same kernels on the same values:
    expected 0); the graph's capture seconds, memory and device ms (replays
    queued behind a sleep kernel); PLANT_PAIRS pairs of PLANT_STEPS steps
    in turns at the log's last tick, ms a step each (host to host)."""
    from wb_humanoid_mpc_tpu_torch.sim.dummy import PlantStep
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    steps = {"graphed": PlantStep(flow, 1.0 / 50.0, dev, torch.float32),
             "eager": PlantStep(flow, 1.0 / 50.0, dev, torch.float32, graphs=False)}
    if steps["graphed"].graph is None or steps["eager"].graph is not None:
        raise AssertionError(f"{what}: PlantStep on the card is not graphed by default, or "
                             f"graphs=False is")
    err = 0.0
    for t, x, u in zip(log.times, log.states, log.inputs):
        got, ref = (torch.from_numpy(step(t, x, u)) for step in steps.values())
        err = max(err, scaled_err([got], [ref], GRAPH_TOL,
                                  f"{what}: the graphed plant step against the eager one at "
                                  f"t = {t}"))
    entry, graph = function_graph(steps["graphed"].graph)
    device_ms = kernel_device_ms(graph.replay, 20)
    t, x, u = log.times[-1], log.states[-1], log.inputs[-1]
    pairs = timed_pairs({side: (lambda step=step: step(t, x, u)) for side, step in steps.items()},
                        PLANT_PAIRS, PLANT_STEPS)
    out = dict(graphed_vs_eager_max_err=err, ticks_compared=len(log.times),
               warmup_s=entry.warmup_s, capture_s=entry.capture_s, pool_bytes=entry.pool_bytes,
               graph_device_ms=device_ms, pairs=pairs,
               graphed_ms_per_step=pairs["graphed"]["median_p50"],
               eager_ms_per_step=pairs["eager"]["median_p50"])
    print(f"{what}: plant step graphed {out['graphed_ms_per_step']:.3f} ms, eager "
          f"{out['eager_ms_per_step']:.3f} ms a step (medians of {PLANT_PAIRS} pairs' p50, "
          f"{PLANT_STEPS} steps each, in turns; per pair graphed {pairs['graphed']['p50']}, "
          f"eager {pairs['eager']['p50']}); the graph {device_ms:.4f} ms on the device, "
          f"captured in {entry.capture_s:.3f} s (warm-up {entry.warmup_s:.3f} s), "
          f"{entry.pool_bytes / 2**20:.1f} MiB; max|graphed - eager| {err:.3e} over "
          f"{len(log.times)} ticks' (t, x, u) (limit {GRAPH_TOL} x max(1, max|ref|)) | {card}")
    return out


STAGED_PAIRS, STAGED_SOLVES = 5, 3


def staged_graphs(torch, riccati, fkvel, pb, cfg, graphed, traj, lam, card: str) -> dict:
    """The staged solver as a user gets it on the card (`graphed`: one CUDA
    graph a phase, captured by its first call) against its eager twin
    (`graphs=False`) on the main path's problem: the same warm start through
    both, and through the first call of a new graphed staged solver (its
    one iteration eager, then only captured), held at GRAPH_TOL x max(1,
    max|ref|) on the trajectory, cost, g_norm and defect norm with the same
    step (the same kernels on the same values: expected 0) and the same K1
    and K2 launches;
    each phase graph's device ms (its replays queued behind a sleep kernel,
    from the loaded inputs); STAGED_PAIRS pairs of STAGED_SOLVES solves in
    turns, the phase seconds of each solve, graphed and eager."""
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_staged_sqp_solver

    eager = make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda",
                                   graphs=False)
    if not hasattr(graphed, "sets") or hasattr(eager, "sets"):
        raise AssertionError("staged: make_staged_sqp_solver on the card did not return the "
                             "graphed solve by default, or graphs=False did not return the "
                             "eager one")
    first = make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
    inputs = (0.0, pb.x0, traj, pb.params, lam)
    sols, counts = {}, {}
    for side, solve in (("eager", eager), ("graphed", graphed), ("first call", first)):
        riccati.reset_launches()
        fkvel.reset_launches()
        sols[side], phases = solve(*inputs)
        torch.cuda.synchronize()
        counts[side] = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES}
        if min(phases) < 0:
            raise AssertionError(f"staged {side}: negative phase time {phases}")
    if not counts["graphed"] == counts["first call"] == counts["eager"]:
        raise AssertionError(f"staged: launches {counts}")
    ref = sols["eager"]
    err = 0.0
    for side in ("graphed", "first call"):
        got = sols[side]
        err = max(err, scaled_err(
            [got.traj.xs, got.traj.us, got.cost, got.g_norm, got.defect_norm],
            [ref.traj.xs, ref.traj.us, ref.cost, ref.g_norm, ref.defect_norm], GRAPH_TOL,
            f"staged: {side} graphed vs eager"))
        if float(got.step_size) != float(ref.step_size):
            raise AssertionError(f"staged: {side} graphed step {float(got.step_size)}, eager "
                                 f"{float(ref.step_size)}")
    (gs,) = graphed.sets.values()
    held = {name: {"K1": n.get(riccati.__name__, 0), "K2": n.get(fkvel.__name__, 0)}
            for name, n in gs.held.items()}
    device_ms = graph_device_ms(gs, inputs)
    seconds = {"graphed": [], "eager": []}
    for i in range(STAGED_PAIRS):
        for side in (("eager", "graphed") if i % 2 == 0 else ("graphed", "eager")):
            solve = graphed if side == "graphed" else eager
            for _ in range(STAGED_SOLVES):
                seconds[side].append(dict(solve(*inputs)[1]._asdict()))
    median = {side: {f: float(np.median([r[f] for r in runs])) for f in runs[0]}
              for side, runs in seconds.items()}
    out = dict(graphed_vs_eager_max_err=err, launches_per_solve=counts["graphed"],
               launches_held=held, phase_device_ms=device_ms, capture_s=gs.capture_s,
               warmup_s=gs.warmup_s, pool_bytes=gs.pool_bytes, phase_s_median=median,
               phase_s=seconds)
    print(f"staged: phase seconds of a solve (medians of {STAGED_PAIRS} pairs of "
          f"{STAGED_SOLVES} solves in turns) graphed {median['graphed']}, eager "
          f"{median['eager']}; each phase graph on the device {device_ms} ms; launches per "
          f"solve {counts['graphed']} graphed and eager, held by the graphs {held}; captured "
          f"in {gs.capture_s:.3f} s (warm-up iteration {gs.warmup_s:.3f} s), "
          f"{gs.pool_bytes / 2**20:.1f} MiB; max|graphed - eager| {err:.3e} (a replay and a "
          f"new solver's first call; limit {GRAPH_TOL} x max(1, max|ref|)), the same step | "
          f"{card}")
    return out


def graphs_phase(torch, riccati, fkvel, card: str) -> dict:
    """The compiled solve against its eager twin on the main path
    (humanoid23, N = 28, f32, one warm-started iteration a solve):
    `make_sqp_solver` as a user gets it on the card (CUDA graphs) and with
    `graphs=False`. The first graphed call's warm-up and capture seconds and
    the memory the capture reserved; both solves on the same inputs, held at
    SOLVE_TOL x max(1, max|ref|) with the same step (the same kernels on the
    same values: expected 0); K1 and K2 per iteration under replay; the
    device time of each graph (its replays queued behind a sleep kernel)
    against the wall time of a synced iteration; the device time that the
    K1/K2 recorders add to an iteration (fresh captures with copies,
    count-only and without, twice in turns); and GRAPH_PAIRS pairs of eager
    and graphed runs in turns (eager first in even pairs), each its
    sustained it/s and synced p50, and the card's clocks after it."""
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver

    pb = build_wb_problem(ASSETS / "humanoid23", N_NODES, device="cuda", dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    graphed = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
    eager = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda", graphs=False)
    if not hasattr(graphed, "sets") or hasattr(eager, "sets"):
        raise AssertionError("graphs: make_sqp_solver on the card did not return the graphed "
                             "solve by default, or graphs=False did not return the eager one")
    for mod in (riccati, fkvel):
        mod.reset_launches()
    t0 = time.perf_counter()
    first = graphed(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (gs,) = graphed.sets.values()
    if (riccati.LAUNCHES, fkvel.LAUNCHES) != (1, 9):
        raise AssertionError(f"graphs: the first call (its eager warm-up iteration, the lower "
                             f"ladder included) launched K1 {riccati.LAUNCHES}, K2 "
                             f"{fkvel.LAUNCHES} times; expected 1 and 9")
    flow = fkvel._FLOW   # the counter of K2's flow variant, a part of K2's
    if any(set(n) - {riccati.__name__, fkvel.__name__, flow} for n in gs.held.values()):
        raise AssertionError(f"graphs: the graphs hold launches of other kernels {gs.held}")
    if any(n.get(flow, 0) != n.get(fkvel.__name__, 0) for n in gs.held.values()):
        raise AssertionError(f"graphs: a K2 launch the graphs hold is not the flow variant "
                             f"{gs.held}")
    held = {name: dict(K1=n.get(riccati.__name__, 0), K2=n.get(fkvel.__name__, 0))
            for name, n in gs.held.items()}
    if held != {"A head": dict(K1=1, K2=6), "B low": dict(K1=0, K2=3),
                "C tail": dict(K1=0, K2=0)}:
        raise AssertionError(f"graphs: launches held by the graphs {held}")

    # the same inputs through both: a warm start from the first solution
    ref = eager(0.0, pb.x0, first.traj, pb.params, first.lam)
    got = graphed(0.0, pb.x0, first.traj, pb.params, first.lam)
    torch.cuda.synchronize()
    err = scaled_err([got.traj.xs, got.traj.us], [ref.traj.xs, ref.traj.us], SOLVE_TOL,
                     "graphs: graphed vs eager")
    if float(got.step_size) != float(ref.step_size):
        raise AssertionError(f"graphs: graphed step {float(got.step_size)}, eager "
                             f"{float(ref.step_size)}")

    # launches under replay
    n_rep = 20
    for mod in (riccati, fkvel):
        mod.reset_launches()
    traj, lam = got.traj, got.lam
    for _ in range(n_rep):
        sol = graphed(0.0, pb.x0, traj, pb.params, lam)
        traj, lam = sol.traj, sol.lam
    torch.cuda.synchronize()
    k1_rep, k2_rep = riccati.LAUNCHES, fkvel.LAUNCHES
    _expect_launches("graphs (replays)", "wb", k1_rep, k2_rep, n_rep)

    # each graph's device time, replays queued behind a sleep kernel
    inputs = (0.0, pb.x0, traj, pb.params, lam)
    graph_ms = graph_device_ms(gs, inputs)
    iteration_device_ms = graph_ms["A head"] + graph_ms["C tail"]
    # and A once more on the state that C's timed replays left (no load):
    # whether A's device time depends on the values it reads
    a_moved_ms = kernel_device_ms(gs.graphs["A head"].replay, 10)

    # what the recorders cost an iteration on the device: the same graphs
    # captured afresh with K1's and K2's recorders installed, as the mrt and
    # launch phases install them (copies of each launch), count-only, as
    # the main path and the batched sweep do, and without any, twice in
    # turns; the cost is the median with a recorder less the median without
    recorder_runs = {"none": [], "copies": [], "count-only": []}
    for kind in list(recorder_runs) * 2:
        recs = ([] if kind == "none" else
                [LaunchRecorder(riccati, "riccati_rollout_cuda", "K1", "cuda",
                                keep=kind == "copies"),
                 LaunchRecorder(fkvel, "flow_map_cuda", "K2", "cuda", keep=kind == "copies")])
        fresh = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cuda")
        try:
            fresh(0.0, pb.x0, first.traj, pb.params, first.lam)
        finally:
            for rec in recs:
                rec.restore()
        (fs,) = fresh.sets.values()
        ms = graph_device_ms(fs, inputs)
        recorder_runs[kind].append(ms["A head"] + ms["C tail"])
        del fresh, fs, recs
    base = float(np.median(recorder_runs["none"]))
    recorder_ms = {k: float(np.median(v)) - base for k, v in recorder_runs.items()
                   if k != "none"}
    print(f"graphs: device ms of A + C in fresh captures {recorder_runs}; the first "
          f"capture's again {graph_device_ms(gs, inputs)}; its A on the state that C's "
          f"timed replays left {a_moved_ms:.3f}; the card reads {clocks()} | {card}")

    pairs = []
    traj_e, lam_e, traj_g, lam_g = first.traj, first.lam, traj, lam
    for i in range(GRAPH_PAIRS):
        row = {}
        for which in (("eager", "graphed") if i % 2 == 0 else ("graphed", "eager")):
            k2 = fkvel.LAUNCHES
            if which == "eager":
                n = sum(GRAPH_EAGER_SOLVES)
                rate, p50, sol = _rate_and_p50(torch, eager, pb, traj_e, lam_e,
                                               *GRAPH_EAGER_SOLVES)
                traj_e, lam_e = sol.traj, sol.lam
            else:
                n = sum(GRAPH_GRAPHED_SOLVES)
                rate, p50, sol = _rate_and_p50(torch, graphed, pb, traj_g, lam_g,
                                               *GRAPH_GRAPHED_SOLVES)
                traj_g, lam_g = sol.traj, sol.lam
            # K2 launches 6 times an iteration and 3 more where the lower
            # ladder runs (graph B, or its eager sweep)
            row[which] = dict(it_per_s=rate, p50_ms=p50, iterations=n,
                              lower_ladder=(fkvel.LAUNCHES - k2 - 6 * n) // 3)
        row["clocks"] = clocks()
        pairs.append(row)
        print(f"graphs pair {i}: eager {row['eager']['it_per_s']:.3f} it/s p50 "
              f"{row['eager']['p50_ms']:.2f} ms, lower ladder in {row['eager']['lower_ladder']} "
              f"of {row['eager']['iterations']} iterations; graphed "
              f"{row['graphed']['it_per_s']:.3f} it/s p50 {row['graphed']['p50_ms']:.2f} ms, "
              f"lower ladder in {row['graphed']['lower_ladder']} of "
              f"{row['graphed']['iterations']}; after it the card read {row['clocks']} "
              f"| {card}")
    med = {w: {k: float(np.median([r[w][k] for r in pairs])) for k in ("it_per_s", "p50_ms")}
           for w in ("eager", "graphed")}
    spread = {w: [float(min(r[w]["it_per_s"] for r in pairs)),
                  float(max(r[w]["it_per_s"] for r in pairs))] for w in ("eager", "graphed")}
    out = dict(first_call_s=first_s, warmup_s=gs.warmup_s, capture_s=gs.capture_s,
               pool_bytes=gs.pool_bytes, graphed_vs_eager_max_err=err,
               k1_per_iteration=k1_rep / n_rep, k2_per_iteration=k2_rep / n_rep,
               graph_device_ms=graph_ms, iteration_device_ms=iteration_device_ms,
               recorder_device_ms_per_iteration=recorder_ms,
               fresh_capture_device_ms=recorder_runs, a_on_moved_state_ms=a_moved_ms,
               median=med, spread_it_per_s=spread, pairs=pairs)
    print(f"graphs: first graphed call {first_s:.2f} s (eager warm-up iteration "
          f"{gs.warmup_s:.2f} s, capture of {len(gs.graphs)} graphs {gs.capture_s:.3f} s); "
          f"memory reserved by the capture {gs.pool_bytes / 2**20:.1f} MiB; launches held "
          f"{held}; max|graphed - eager| {err:.3e} (limit {SOLVE_TOL} x max(1, max|ref|)), "
          f"the same step; under replay K1 {k1_rep / n_rep:.2f} K2 {k2_rep / n_rep:.2f} per "
          f"iteration | {card}")
    print(f"graphs: device ms per replay A {graph_ms['A head']:.3f}, B {graph_ms['B low']:.3f}, "
          f"C {graph_ms['C tail']:.3f}; an iteration without the lower ladder "
          f"{iteration_device_ms:.3f} ms on the device against a synced wall p50 "
          f"{med['graphed']['p50_ms']:.2f} ms ({100 * iteration_device_ms / med['graphed']['p50_ms']:.1f} "
          f"% busy); the recorders add {recorder_ms['copies']:.4f} ms an iteration on the device "
          f"with copies, {recorder_ms['count-only']:.4f} ms count-only; medians of "
          f"{GRAPH_PAIRS} pairs: eager {med['eager']['it_per_s']:.3f} it/s "
          f"p50 {med['eager']['p50_ms']:.2f} ms, graphed {med['graphed']['it_per_s']:.3f} it/s "
          f"p50 {med['graphed']['p50_ms']:.2f} ms; it/s ranges eager {spread['eager']}, "
          f"graphed {spread['graphed']} | {card}")
    return out


MUJOCO_Z_REF = 0.78321                # humanoid23's defaultBaseHeight
MUJOCO_GATES = dict(min_height=0.75 * MUJOCO_Z_REF, max_drift=0.25)   # tests/test_mujoco_loop.py
NO_MUJOCO = ("this machine has no mujoco, so the MuJoCo loop was held on the CPU tier only "
             "(tests/test_torch_mujoco_sim.py, tests/test_torch_sim_thread.py)")


def _expect_launches(what: str, form: str, k1: int, k2: int, n_it: int) -> None:
    """K1 once per SQP iteration; K2 6 to 9 times per iteration whole-body,
    never centroidal."""
    if k1 != n_it:
        raise AssertionError(f"{what}: K1 launched {k1} times in {n_it} SQP iterations")
    lo, hi = (6 * n_it, 9 * n_it) if form == "wb" else (0, 0)
    if not lo <= k2 <= hi:
        raise AssertionError(f"{what}: K2 launched {k2} times in {n_it} SQP iterations, "
                             f"expected {lo}..{hi}")


def launch_phase(torch, riccati, fkvel, card: str) -> dict:
    """The launch CLI, in-process, as a user runs it on the card (humanoid23,
    f32, N = 28): `dummy-sim --formulation wb` for 1.0 s at 50 / 25 Hz with
    `--log-csv`, then `bench-batched --batch 8 --rounds 2`. Each with the
    launch counts set to 0 just before it: K1 once per SQP iteration, K2 6
    to 9 times; finite states, one CSV row per tick under the JAX logger's
    header. The dummy-sim's last K1 and K2 launches are held against the
    plain versions on the same inputs, and its plant step, graphed against
    eager, by `plant_step_report` at the ticks it logged."""
    import tempfile

    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, load_wb_model
    from wb_humanoid_mpc_tpu_torch.tools import launch
    from wb_humanoid_mpc_tpu_torch.tools.observation_logger import ObservationLogger

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "observations.csv")
        recorders = [LaunchRecorder(riccati, "riccati_rollout_cuda", "K1", "cuda"),
                     LaunchRecorder(fkvel, "flow_map_cuda", "K2", "cuda")]
        for mod in (riccati, fkvel):
            mod.reset_launches()
        t0 = time.perf_counter()
        try:
            res = launch.main(["dummy-sim", "--formulation", "wb", "--duration", "1.0",
                               "--mrt-freq", "50", "--mpc-freq", "25", "--n-nodes",
                               str(N_NODES), "--log-csv", csv_path])
            torch.cuda.synchronize()
        finally:
            for rec in recorders:
                rec.restore()
        caps = {**recorders[0].last(), **recorders[1].last()}
        wall = time.perf_counter() - t0
        k1, k2 = riccati.LAUNCHES, fkvel.LAUNCHES
        log = res["log"]
        n_it = sum(s.iterations for s in log.solve_stats)
        _expect_launches("launch dummy-sim", "wb", k1, k2, n_it)
        if not np.isfinite(log.states).all():
            raise AssertionError("launch dummy-sim: non-finite state")
        header, data = ObservationLogger.load_csv(csv_path)
        nx, nu = log.states.shape[1], log.inputs.shape[1]
        want = (["time", "mode"] + [f"state_{i}" for i in range(nx)]
                + [f"input_{i}" for i in range(nu)])
        if header != want or data.shape != (len(log.times), len(want)):
            raise AssertionError(f"launch dummy-sim: CSV {data.shape} with header "
                                 f"{header[:3]}..., expected {len(log.times)} rows of "
                                 f"{want[:3]}...")
        args, kwargs, got = caps["K1"]
        e1 = max_err(got, riccati.riccati_rollout_plain(*args, **kwargs),
                     what="launch dummy-sim K1 (last launch)", **K1_TOL)
        args, kwargs, got = caps["K2"]
        e2 = flow_vs_plain(*args, got, what="launch dummy-sim K2 (last launch)")
    summary = res["summary"]
    out["dummy-sim"] = dict(summary=summary, ticks=len(log.times), wall_s=wall,
                            ticks_per_s=len(log.times) / wall, sqp_iterations=n_it,
                            launches={"K1": k1, "K2": k2}, k1_last_vs_plain=e1,
                            k2_last_vs_plain=e2, final_base_xy=res["final_base_xy"],
                            plant_step=plant_step_report(
                                torch, load_wb_model(ASSETS / "humanoid23")[1].flow_map, log,
                                card, "launch dummy-sim wb"))
    print(f"launch dummy-sim wb: BenchmarksPublisher summary {json.dumps(summary)}")
    print(f"launch dummy-sim wb (graphed solves, holding the K1/K2 recorders' copies, and "
          f"graphed plant steps): "
          f"{len(log.times)} ticks (CSV rows) in "
          f"{wall:.2f} s, "
          f"{len(log.times) / wall:.3f} ticks/s of wall time; launches in {n_it} SQP "
          f"iterations K1 {k1} K2 {k2}; last K1 vs plain {e1:.3e}, last K2 vs plain {e2:.3e} "
          f"| {card}")

    for mod in (riccati, fkvel):
        mod.reset_launches()
    res = launch.main(["bench-batched", "--batch", "8", "--rounds", "2", "--n-nodes",
                       str(N_NODES)])
    torch.cuda.synchronize()
    k1, k2 = riccati.LAUNCHES, fkvel.LAUNCHES
    _expect_launches("launch bench-batched", "wb", k1, k2, 3)   # 1 + 2 rounds, 1 iteration each
    if not res["finite"]:
        raise AssertionError("launch bench-batched: non-finite cost")
    out["bench-batched"] = dict(res, launches={"K1": k1, "K2": k2})
    print(f"launch bench-batched B=8 (graphed): {res['instances_per_s']:.2f} instances/s, "
          f"{res['round_time_s'] * 1e3:.2f} ms a batched iteration; launches in 3 batched "
          f"iterations K1 {k1} K2 {k2} | {card}")
    return out


BENCH_TIMED, BENCH_SAMPLES = 20, 5
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def bench_phase(torch, riccati, fkvel, card: str) -> dict:
    """The bench entry, in-process, as a user runs it (humanoid23, N = 28,
    f32): `tools.bench.main` with `--timed 20 --latency-samples 5`, its
    standard output and error captured: one JSON line with `bench.py`'s four
    keys, a finite value > 0, vs_baseline = round(value / 60, 3), K1 once per
    solve (1 + 20 + 5) and K2 6 to 9 times. Then `scaling_report((1, 8))`
    with `solver_overrides={}`: both points finite, K1 once per batched
    iteration. Launch counts set to 0 just before each."""
    import contextlib
    import io

    from wb_humanoid_mpc_tpu_torch.parallel.scaling import scaling_report
    from wb_humanoid_mpc_tpu_torch.tools import bench

    for mod in (riccati, fkvel):
        mod.reset_launches()
    out_buf, err_buf = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_buf), contextlib.redirect_stderr(err_buf):
        res = bench.main(["--timed", str(BENCH_TIMED), "--latency-samples", str(BENCH_SAMPLES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = riccati.LAUNCHES, fkvel.LAUNCHES
    lines = out_buf.getvalue().strip().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != res or list(res) != BENCH_KEYS:
        raise AssertionError(f"bench: printed {lines!r}, returned {res!r}")
    if not (np.isfinite(res["value"]) and res["value"] > 0
            and res["vs_baseline"] == round(res["value"] / 60.0, 3)):
        raise AssertionError(f"bench: value {res['value']}, vs_baseline {res['vs_baseline']}")
    _expect_launches("bench", "wb", k1, k2, 1 + BENCH_TIMED + BENCH_SAMPLES)
    stderr = err_buf.getvalue().strip()
    print(lines[0])
    print(f"bench (graphed solve): {stderr}; launches in {1 + BENCH_TIMED + BENCH_SAMPLES} "
          f"solves K1 {k1} "
          f"K2 {k2}; {wall:.2f} s in all | {card}")

    for mod in (riccati, fkvel):
        mod.reset_launches()
    report = scaling_report((1, 8), N_NODES, solver_overrides={}, device="cuda")
    torch.cuda.synchronize()
    sk1, sk2 = riccati.LAUNCHES, fkvel.LAUNCHES
    if [r.get("batch") for r in report] != [1, 8] or not all(r.get("finite") for r in report):
        raise AssertionError(f"scaling_report((1, 8)): {report}")
    n_it = 2 * (1 + 30)   # two points of 1 + n_rounds (30, batched_throughput's default)
    _expect_launches("scaling_report", "wb", sk1, sk2, n_it)
    for r in report:
        print(f"scaling_report B={r['batch']} (graphed): {r['instances_per_s']:.2f} instances/s, "
              f"{r['sqp_iterations_per_s']:.2f} SQP it/s, {r['round_time_s'] * 1e3:.2f} ms a "
              f"batched iteration | {card}")
    return {"line": res, "stderr": stderr, "wall_s": wall, "launches": {"K1": k1, "K2": k2},
            "scaling_report": report, "scaling_launches": {"K1": sk1, "K2": sk2}}


def _mujoco_sim(mpc, mjcf: str):
    from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface

    lay, x0 = mpc.model.layout, mpc.initial_state
    return MujocoSimInterface(
        mjcf, initial_joint_positions=dict(zip(mpc.model.robot.joint_names,
                                               map(float, lay.joint_angles(x0)))),
        initial_base_pos=(0.0, 0.0, float(lay.base_position(x0)[2])))


def _timed_controller(ctrl):
    """Wrap ctrl.compute to record its host time and the age of the policy
    it is given (sim time - the policy's t0)."""
    orig = ctrl.compute
    rec = {"ms": [], "age": []}

    def compute(t, x, policy):
        c0 = time.perf_counter()
        a = orig(t, x, policy)
        rec["ms"].append((time.perf_counter() - c0) * 1e3)
        if policy is not None:
            rec["age"].append(t - policy.t0)
        return a

    ctrl.compute = compute
    return rec


def mujoco_phase(torch, riccati, fkvel, card: str, device: str = "cuda") -> dict:
    """The MuJoCo physics loop on humanoid23's MJCF (f32, N = 28), the solves
    on the card: `run_mujoco_closed_loop` synchronous for both formulations
    (1.0 s: 2 kHz physics, 500 Hz MRT, 25 Hz MPC), the first 3 solves held
    against the same loop on the plain versions; the centroidal loop again
    with `solve_latency = 0.012`; `run_threaded_robot_sim` (centroidal,
    0.5 s at 250 Hz, faster than real time). Gates: no reset, base above
    0.75 x 0.78321 m, horizontal drift under 0.25 m, finite costs; K1 once
    per SQP iteration, K2 6 to 9 times (whole-body) or never (centroidal).
    The threaded loop's resets, heights, policy ages and realtime factor are
    reported, not gated."""
    import threading

    from wb_humanoid_mpc_tpu_torch.core.config import load_task_config
    from wb_humanoid_mpc_tpu_torch.interface import (
        ASSETS,
        build_centroidal_mpc,
        build_wb_mpc,
        mpc_files,
    )
    from wb_humanoid_mpc_tpu_torch.mpc.controller import (
        CentroidalMrtController,
        WBMrtController,
    )
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import run_mujoco_closed_loop
    from wb_humanoid_mpc_tpu_torch.sim.sim_thread import run_threaded_robot_sim

    mjcf = str(ASSETS / "humanoid23" / "humanoid23.xml")
    classes = {"wb": (build_wb_mpc, WBMrtController),
               "centroidal": (build_centroidal_mpc, CentroidalMrtController)}

    def build(form, **overrides):
        files = mpc_files(ASSETS / "humanoid23", form)
        kw = dict(n_nodes=N_NODES)
        if form == "wb":
            kw["dt_override"] = load_task_config(files[1], "wb", 1, 1).sqp.dt
        mpc = classes[form][0](*files, **kw, solver_overrides=overrides or None, device=device)
        return mpc, classes[form][1](mpc.model, device=device)

    def gate(what, log):
        drift = float(np.abs(log.base_positions[-1, :2]).max())
        if log.n_resets:
            raise AssertionError(f"{what}: the robot fell ({log.n_resets} resets)")
        if not log.base_heights.min() > MUJOCO_GATES["min_height"]:
            raise AssertionError(f"{what}: base height {log.base_heights.min():.4f} m")
        if not drift < MUJOCO_GATES["max_drift"]:
            raise AssertionError(f"{what}: horizontal drift {drift:.4f} m")
        if not all(np.isfinite(s.cost) for s in log.solve_stats):
            raise AssertionError(f"{what}: non-finite cost")
        return drift

    def report(what, log, rec, wall, launches, n_it, drift):
        solve_ms = np.array([s.solve_time for s in log.solve_stats]) * 1e3
        sim_s = len(log.times) * (log.times[1] - log.times[0])
        row = dict(solves=len(log.solve_stats), sqp_iterations=n_it, launches=launches,
                   solve_ms_p50=float(np.percentile(solve_ms, 50)),
                   solve_ms_p90=float(np.percentile(solve_ms, 90)),
                   controller_ms_p50=float(np.percentile(rec["ms"], 50)),
                   ticks=len(log.times), ticks_per_s=len(log.times) / wall,
                   realtime_factor=sim_s / wall, resets=log.n_resets,
                   height=[float(log.base_heights.min()), float(log.base_heights.max())],
                   drift=drift)
        print(f"{what}: {row['solves']} solves, {n_it} SQP iterations, launches {launches}; "
              f"solve p50 {row['solve_ms_p50']:.2f} ms p90 {row['solve_ms_p90']:.2f} ms; "
              f"controller p50 {row['controller_ms_p50']:.2f} ms; {row['ticks_per_s']:.3f} MRT "
              f"ticks/s of wall time; realtime factor {row['realtime_factor']:.4f}; resets "
              f"{log.n_resets}; base height {row['height'][0]:.4f}..{row['height'][1]:.4f} m; "
              f"drift {drift:.4f} m | {card}")
        return row

    out = {}
    runs = [("sync", "centroidal", 0.0), ("sync", "wb", 0.0), ("latency", "centroidal", 0.012)]
    for mode, form, latency in runs:
        mpc, ctrl = build(form)
        # warm: one solve and one controller call (the first of a process are slow)
        mpc.runtime.advance(0.0, mpc.initial_state, np.zeros(4))
        ctrl.compute(0.0, mpc.initial_state, mpc.runtime.policy)
        mpc.runtime.reset()
        record = _recording(mpc.runtime, riccati, fkvel)
        rec = _timed_controller(ctrl)
        sim = _mujoco_sim(mpc, mjcf)
        for mod in (riccati, fkvel):
            mod.reset_launches()
        t0 = time.perf_counter()
        log = run_mujoco_closed_loop(mpc, ctrl, sim, 1.0, 500.0, 25.0,
                                     command_fn=lambda t: np.zeros(4), solve_latency=latency)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES}
        del mpc.runtime.advance   # the recording wrapper
        what = f"mujoco {mode} {form}"
        n_it = sum(r["stats"].iterations for r in record)
        _expect_launches(what, form, launches["K1"], launches["K2"], n_it)
        drift = gate(what, log)
        row = report(what, log, rec, wall, launches, n_it, drift)
        if mode == "sync":
            # the first 3 solves against the same loop on the plain versions
            pmpc, pctrl = build(form, rollout_backend="plain", flow_backend="plain")
            precord = _recording(pmpc.runtime, riccati, fkvel)
            run_mujoco_closed_loop(pmpc, pctrl, _mujoco_sim(pmpc, mjcf), 41 / 500.0, 500.0,
                                   25.0, command_fn=lambda t: np.zeros(4))
            errs = []
            for k in range(3):
                kr, pr = record[k], precord[k]
                if pr["k1"] or pr["k2"]:
                    raise AssertionError(f"{what}: the plain twin launched a kernel")
                err = float(np.abs(kr["xs"] - pr["xs"]).max())
                limit = SOLVE_TOL * max(1.0, float(np.abs(pr["xs"]).max()))
                if not err <= limit:
                    raise AssertionError(f"{what} solve {k}: kernels and plain versions "
                                         f"disagree on xs: {err:.3e} > {limit:.3e}")
                if kr["stats"].step_size != pr["stats"].step_size:
                    raise AssertionError(f"{what} solve {k}: kernels took step "
                                         f"{kr['stats'].step_size}, plain versions "
                                         f"{pr['stats'].step_size}")
                errs.append(err)
            row["vs_plain_max_dxs"] = max(errs)
            print(f"{what}: first 3 solves vs plain versions max|dxs| {max(errs):.3e} (limit "
                  f"{SOLVE_TOL} x max(1, max|ref|)), the same steps")
        out[f"{mode} {form}"] = row

    # the three threads: physics, solver, control; reported, not gated
    mpc, ctrl = build("centroidal")
    mpc.runtime.advance(0.0, mpc.initial_state, np.zeros(4))
    ctrl.compute(0.0, mpc.initial_state, mpc.runtime.policy)
    mpc.runtime.reset()
    rec = _timed_controller(ctrl)
    for mod in (riccati, fkvel):
        mod.reset_launches()
    t0 = time.perf_counter()
    log, metrics, _ = run_threaded_robot_sim(mpc, ctrl, _mujoco_sim(mpc, mjcf), 0.5, 250.0,
                                             command_fn=lambda t: np.zeros(4), realtime=False)
    wall = time.perf_counter() - t0
    launches = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES}
    alive = [t.name for t in threading.enumerate() if t.name in ("mujoco-sim", "mpc-solver")]
    if not log.solve_stats or metrics.ticks <= 0 or alive:
        raise AssertionError(f"mujoco threaded: {len(log.solve_stats)} policies, "
                             f"{metrics.ticks} physics ticks, threads still alive {alive}")
    # the thread may stop mid-solve and the control loop may miss a policy,
    # so the counts are bounded, not matched to the solves
    if launches["K1"] < 1 or launches["K2"] != 0:
        raise AssertionError(f"mujoco threaded: launches {launches}")
    ages = np.array(rec["age"]) * 1e3
    solve_ms = np.array([s.solve_time for s in log.solve_stats]) * 1e3
    row = dict(policies=len(log.solve_stats), launches=launches, ticks=len(log.times),
               physics_ticks=metrics.ticks, resets=log.n_resets,
               min_height=float(log.base_heights.min()),
               policy_age_ms_p50=float(np.percentile(ages, 50)) if ages.size else None,
               policy_age_ms_max=float(ages.max()) if ages.size else None,
               solve_ms_p50=float(np.percentile(solve_ms, 50)),
               controller_ms_p50=float(np.percentile(rec["ms"], 50)),
               ticks_per_s=len(log.times) / wall, realtime_factor=0.5 / wall,
               physics_realtime_factor=metrics.realtime_factor)
    out["threaded centroidal"] = row
    print(f"mujoco threaded centroidal (0.5 s at 250 Hz, not real time): {row['policies']} "
          f"policies, launches {launches}; solve p50 {row['solve_ms_p50']:.2f} ms; controller "
          f"p50 {row['controller_ms_p50']:.2f} ms; policy age p50 {row['policy_age_ms_p50']} ms "
          f"max {row['policy_age_ms_max']} ms (sim time); {row['ticks_per_s']:.3f} MRT ticks/s "
          f"of wall time; realtime factor {row['realtime_factor']:.4f} (physics thread's "
          f"{metrics.realtime_factor:.4f}); resets {log.n_resets}; min base height "
          f"{row['min_height']:.4f} m | {card}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem, load_wb_model
    from wb_humanoid_mpc_tpu_torch.ops import _lib, fkvel, riccati, rollout
    from wb_humanoid_mpc_tpu_torch.solver.ddp import make_ddp_solver
    from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq
    from wb_humanoid_mpc_tpu_torch.solver.riccati import (
        backward_pass,
        forward_pass,
        levenberg_damp,
    )
    from wb_humanoid_mpc_tpu_torch.solver.sqp import (
        SqpSolverConfig,
        make_sqp_solver,
        make_staged_sqp_solver,
    )
    from wb_humanoid_mpc_tpu_torch.solver.transcription import make_lq_functions
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    # ---- 1. the card ----
    dev = resolve_device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)   # nvidia-smi's own line: the card's name and power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # ---- 2. build ----
    info = _lib.build_info()
    print(f"build: {info['seconds']:.1f} s (nvcc, sm_90a, one process per source)")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    rows = {}

    # ---- 3. K2: FK + velocity tree pass ----
    _, model = load_wb_model(ASSETS / "humanoid23")
    robot = model.robot
    rng = np.random.default_rng(0)
    k2_err = 0.0
    k2_ms = {}
    for B in (28, 2 * 28, 6 * 28, 8 * 28):   # 8 x 28: the merit search's 8 candidates
        q = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.3, dtype=torch.float32, device=dev)
        v = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.5, dtype=torch.float32, device=dev)
        fk_k, vb_k = fkvel.fkvel_cuda(robot, q, v)
        fk_p, vb_p = fkvel.fkvel_plain(robot, q, v)
        torch.cuda.synchronize()
        err = max_err(list(fk_k) + list(vb_k), list(fk_p) + list(vb_p), what=f"K2 B={B}",
                      **K2_TOL)
        k2_err = max(k2_err, err)
        t_dev = kernel_device_ms(lambda: fkvel.fkvel_cuda(robot, q, v), 50)
        t_k = cuda_time_ms(lambda: fkvel.fkvel_cuda(robot, q, v), 200)
        t_p = cuda_time_ms(lambda: fkvel.fkvel_plain(robot, q, v), 20)
        k2_ms[B] = (t_dev, t_p)
        nbytes, ops = fkvel_work(B, robot.n_joints, 4)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"K2 fkvel B={B}: max|kernel-plain| {err:.3e}; kernel {t_dev * 1e3:.2f} us on the "
              f"device, {t_k * 1e3:.2f} us per call with its wrapper; plain {t_p * 1e3:.1f} us "
              f"per call; bound {b_ms * 1e3:.4f} us ({b_by}: {nbytes / 1e3:.1f} KB, "
              f"{ops / 1e6:.3f} MFLOP)")
    nbytes, ops = fkvel_work(28, robot.n_joints, 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["fkvel"] = dict(name="fkvel", route="cuda",
                         source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                         replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                         max_abs_err=k2_err, ms=k2_ms[28][0], plain_ms=k2_ms[28][1],
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- 3b. K2's flow variant: the whole-body flow map in one launch, at the
    # rows of a whole-body solve of 29 nodes (RK4 tail, top-2 sweep, lower
    # ladder), stance wrenches near a standing pose ----
    flow_ms, flow_err = {}, 0.0
    n_c = len(model.contact_frames)
    for B in (29, 2 * 29, 6 * 29):
        q = np.concatenate([rng.normal(size=(B, 2)) * 0.5, 0.75 + rng.normal(size=(B, 1)) * 0.03,
                            rng.normal(size=(B, 3)) * 0.1,
                            rng.normal(size=(B, robot.n_joints)) * 0.3], 1)
        w = [np.concatenate([rng.normal(size=(B, 2)) * 2.5,
                             0.5 * robot.total_mass * robot.gravity + rng.normal(size=(B, 1)) * 5,
                             rng.normal(size=(B, 3))], 1) for _ in range(n_c)]
        xs = torch.as_tensor(np.concatenate([q, rng.normal(size=(B, robot.nq)) * 0.5], 1),
                             dtype=torch.float32, device=dev)
        us = torch.as_tensor(np.concatenate(w + [rng.normal(size=(B, robot.n_joints)) * 3], 1),
                             dtype=torch.float32, device=dev)
        got = fkvel.flow_map_cuda(model, xs, us)
        torch.cuda.synchronize()
        err = flow_vs_plain(model, xs, us, got, what=f"K2 flow variant rows={B}")
        flow_err = max(flow_err, err)
        t_dev = kernel_device_ms(lambda: fkvel.flow_map_cuda(model, xs, us), 50)
        t_k = cuda_time_ms(lambda: fkvel.flow_map_cuda(model, xs, us), 200)
        t_p = cuda_time_ms(lambda: model.flow_map_batch(None, xs, us, backend="plain"), 20)
        flow_ms[B] = (t_dev, t_p)
        nbytes, ops = fkvel_flow_work(B, robot.n_joints, n_c, 4)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"K2 flow variant rows={B}: max|kernel-plain float64| {err:.3e}; kernel "
              f"{t_dev * 1e3:.2f} us on the device, {t_k * 1e3:.2f} us per call with its "
              f"wrapper; plain (FK pass + base-rows dynamics) {t_p * 1e3:.1f} us per call; "
              f"bound {b_ms * 1e3:.4f} us ({b_by}: {nbytes / 1e3:.1f} KB, {ops / 1e6:.3f} "
              f"MFLOP), {100 * b_ms / t_dev:.3f} % of it")
    nbytes, ops = fkvel_flow_work(29, robot.n_joints, n_c, 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["fkvel_flow"] = dict(name="fkvel flow", route="cuda",
                              source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                              replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                              max_abs_err=flow_err, ms=flow_ms[29][0], plain_ms=flow_ms[29][1],
                              bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- 4. K1: fused Riccati + rollout ----
    def lq_tensors(seed, N, nx, nu, quu_span=1.0, batch=None, dtype=np.float32):
        r = np.random.default_rng(seed)
        if batch is None:
            data = riccati.random_lq_data(r, N, nx, nu, dtype=dtype, quu_span=quu_span)
        else:
            parts = [riccati.random_lq_data(r, N, nx, nu, dtype=dtype, quu_span=quu_span)
                     for _ in range(batch)]
            data = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        return [torch.as_tensor(data[k], device=dev) for k in
                ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]

    k1_err = 0.0
    k1_case = {}
    for label, shape, args in (
            ("(28,58,21)", (28, 58, 21, 4), lq_tensors(7, 28, 58, 21)),
            ("(28,58,21) quu_span=100", (28, 58, 21, 4), lq_tensors(8, 28, 58, 21,
                                                                    quu_span=100.0)),
            ("(28,58,21) batch=4", (28, 58, 21, 4), lq_tensors(9, 28, 58, 21, batch=4)),
            ("(28,58,35)", (28, 58, 35, 4), lq_tensors(16, 28, 58, 35)),
            ("(28,58,21) f64", (28, 58, 21, 8), lq_tensors(17, 28, 58, 21, dtype=np.float64))):
        out_k = riccati.riccati_rollout_cuda(*args, reg=1e-8)
        out_p = riccati.riccati_rollout_plain(*args, reg=1e-8)
        torch.cuda.synchronize()
        err = max_err(out_k, out_p, what=f"K1 {label}", **K1_TOL)
        t_dev = kernel_device_ms(lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8), 20)
        t_k = cuda_time_ms(lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8), 100)
        t_p = cuda_time_ms(lambda: riccati.riccati_rollout_plain(*args, reg=1e-8), 10)
        k1_case[label] = (t_dev, t_p)
        if label == "(28,58,21)":
            k1_err = err
        N_, nx_, nu_, size = shape
        nbytes, ops = riccati_work(1, N_, nx_, nu_, size)
        peak = PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS
        card_ms = max(nbytes / PEAK_BYTES, ops / peak) * 1e3
        sm_ms = ops / (peak / N_SMS) * 1e3
        print(f"K1 riccati {label}: max|kernel-plain| {err:.3e}; kernel {t_dev * 1e3:.1f} us on "
              f"the device, {t_k * 1e3:.1f} us per call with its wrapper; plain "
              f"{t_p * 1e3:.1f} us per call; card-wide bound {card_ms * 1e3:.3f} us, one-SM "
              f"floor {sm_ms * 1e3:.1f} us ({ops / 1e6:.1f} MFLOP per instance)")
    nbytes, ops = riccati_work(1, 28, 58, 21, 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    t_k, t_p = k1_case["(28,58,21)"]
    rows["riccati"] = dict(name="riccati_rollout", route="cuda",
                           source="wb_humanoid_mpc_tpu_torch/csrc/riccati.cu",
                           replaces="wb_humanoid_mpc_tpu/ops/riccati.py:129",
                           max_abs_err=k1_err, ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)

    # ---- 5. main path: warm-started SQP iterations, humanoid23, N = 28 ----
    pb = build_wb_problem(ASSETS / "humanoid23", N_NODES, device="cuda", dtype=torch.float32)
    scfg = SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, scfg, device="cuda")
    print(f"main path: humanoid23 nx {pb.model.state_dim} nu {pb.model.input_dim} "
          f"n_eq {pb.ocp.n_eq} N {N_NODES}, stance, f32, graphed solve (make_sqp_solver's "
          f"default on the card; the first call captures)")

    # the counts above are the wrappers' (a replay adds what its graph
    # recorded at capture); count-only recorders count the same launches on
    # the device, in the graphs (one one-element add a launch, kept alive
    # with the solve since its graphs write to them)
    counters = [LaunchRecorder(riccati, "riccati_rollout_cuda", "K1", "cuda", keep=False),
                LaunchRecorder(fkvel, "flow_map_cuda", "K2", "cuda", keep=False)]
    fkvel.reset_launches()
    riccati.reset_launches()
    t0 = time.perf_counter()
    try:
        sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    finally:
        for rec in counters:
            rec.restore()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    traj = sol.traj
    n_sustained = 20
    t0 = time.perf_counter()
    for _ in range(n_sustained):
        sol = solve(0.0, pb.x0, traj, pb.params, pb.lam)
        traj = sol.traj
    torch.cuda.synchronize()
    sustained = n_sustained / (time.perf_counter() - t0)
    lat = []
    for _ in range(10):
        t1 = time.perf_counter()
        sol = solve(0.0, pb.x0, traj, pb.params, pb.lam)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        traj = sol.traj
    launches = {"riccati": riccati.LAUNCHES, "fkvel": fkvel.LAUNCHES}
    on_device = {"riccati": counters[0].counts()["K1"], "fkvel": counters[1].counts()["K2"]}
    if on_device != launches:
        raise AssertionError(f"main path: the wrappers counted {launches}, the device "
                             f"{on_device}")
    n_iter = 1 + n_sustained + 10
    p50 = float(np.percentile(lat, 50))
    cost, g_norm = float(sol.cost), float(sol.g_norm)
    if not (np.isfinite(cost) and np.isfinite(g_norm)):
        raise AssertionError(f"main path: non-finite cost {cost} / g_norm {g_norm}")
    if launches["riccati"] != n_iter:
        raise AssertionError(f"K1 launched {launches['riccati']} times in {n_iter} iterations")
    if not 6 * n_iter <= launches["fkvel"] <= 9 * n_iter:
        raise AssertionError(f"K2 launched {launches['fkvel']} times in {n_iter} iterations "
                             f"(expected 6 to 9 per iteration)")
    print(f"main path: first solve {t_first:.2f} s; cost {cost:.6g} g_norm {g_norm:.3e} "
          f"step {float(sol.step_size)}; launches in {n_iter} iterations: K1 "
          f"{launches['riccati']}, K2 {launches['fkvel']} (the same counted on the device)")
    print(f"main path: sustained {sustained:.2f} SQP it/s, per-call p50 {p50 * 1e3:.2f} ms "
          f"(graphs holding the device counters' adds) | {card}")

    # the same solve on the plain versions, on the card
    plain = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt,
                                            rollout_backend="plain", flow_backend="plain"),
                            device="cuda")
    ref = plain(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    got = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    torch.cuda.synchronize()
    for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us)):
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        print(f"main path vs plain versions: max|d{what}| {err:.3e} "
              f"(limit {SOLVE_TOL * scale:.3e})")
        if not err <= SOLVE_TOL * scale:
            raise AssertionError(f"main path: kernels and plain versions disagree on {what}")
    if float(got.step_size) != float(ref.step_size):
        raise AssertionError("main path: kernels and plain versions took different steps")

    rows["riccati"]["launches"] = launches["riccati"]
    rows["fkvel_flow"]["launches"] = launches["fkvel"]   # every main-path K2 launch

    # ---- 5b. the compiled solve against its eager twin ----
    compiled = graphs_phase(torch, riccati, fkvel, card)
    print(json.dumps({"graphs": compiled, "card": card}))

    # ---- 6. K3: the forward rollout alone ----
    def stage_tensors(seed, N, nx, nu, dtype=torch.float32, batch=None):
        r = np.random.default_rng(seed)
        parts = [rollout.random_stage_data(r, N, nx, nu, dtype=np.float64)
                 for _ in range(batch or 1)]
        return [torch.as_tensor(np.stack([q[k] for q in parts]) if batch else parts[0][k],
                                dtype=dtype, device=dev)
                for k in ("A", "B", "d", "K", "k", "dx0")]

    from wb_humanoid_mpc_tpu_torch.tools import launch_floor

    empty_lib = launch_floor.build()   # the launch floor: an empty kernel of K3's geometry
    k3_err = 0.0
    k3_case = {}
    for label, args, tol in (
            ("(28,58,35)", stage_tensors(10, 28, 58, 35), K3_TOL["f32"]),
            ("(28,58,21)", stage_tensors(11, 28, 58, 21), K3_TOL["f32"]),
            ("(15,35,35)", stage_tensors(12, 15, 35, 35), K3_TOL["f32"]),
            ("(7,12,5)", stage_tensors(13, 7, 12, 5), K3_TOL["f32"]),
            ("(28,58,35) batch=4", stage_tensors(14, 28, 58, 35, batch=4), K3_TOL["f32"]),
            ("(28,58,35) f64 ring", stage_tensors(15, 28, 58, 35, dtype=torch.float64),
             K3_TOL["f64"])):
        A_ = args[0]
        plan = rollout.rollout_plan(A_.shape[-3], A_.shape[-1], args[1].shape[-1], A_.dtype)
        batch = A_.shape[0] if A_.dim() == 4 else 1

        def run_k(args=args):
            return rollout.forward_rollout_cuda(*args)

        out_k = run_k()
        out_p = rollout.forward_rollout_plain(*args)
        again = run_k()
        torch.cuda.synchronize()
        err = scaled_err(out_k, out_p, tol, f"K3 {label}")
        if not all(torch.equal(a, b) for a, b in zip(out_k, again)):
            raise AssertionError(f"K3 {label}: two launches on the same inputs differ")
        t_dev = kernel_device_ms(run_k, 20)
        t_floor = kernel_device_ms(launch_floor.empty_launcher(
            empty_lib, batch, plan["cluster"], plan["threads"], plan["smem_bytes"]), 20)
        t_k = cuda_time_ms(run_k, 100)
        t_p = cuda_time_ms(lambda: rollout.forward_rollout_plain(*args), 10)
        k3_case[label] = (t_dev, t_p, t_floor)
        if "f64" not in label:
            k3_err = max(k3_err, err)
        print(f"K3 rollout {label}: cluster {plan['cluster']}, {plan['slots']} stage slots and "
              f"{plan['smem_bytes']} shared bytes a CTA, cudaOccupancyMaxActiveClusters "
              f"{plan['max_active_clusters']}; max|kernel-plain| {err:.3e} (limit {tol:g} x "
              f"max(1, max|ref|)); kernel {t_dev * 1e3:.2f} us on the device (launch floor "
              f"{t_floor * 1e3:.2f} us), {t_k * 1e3:.2f} us per call with its wrapper; plain "
              f"{t_p * 1e3:.1f} us per call")
    for label, shape in (("(28,58,35)", (28, 58, 35)), ("(28,58,21)", (28, 58, 21))):
        nbytes, ops = rollout_work(1, *shape, 4)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"K3 bound {label} f32: {b_ms * 1e3:.4f} us ({b_by}: {nbytes / 1e3:.1f} KB, "
              f"{ops / 1e6:.3f} MFLOP); kernel at {100 * b_ms / k3_case[label][0]:.3f} % of it")
    nbytes, ops = rollout_work(1, 28, 58, 35, 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["rollout"] = dict(name="forward_rollout", route="cuda",
                           source="wb_humanoid_mpc_tpu_torch/csrc/rollout.cu",
                           replaces="wb_humanoid_mpc_tpu/ops/rollout.py:65",
                           max_abs_err=k3_err, ms=k3_case["(28,58,35)"][0],
                           plain_ms=k3_case["(28,58,35)"][1], bound_ms=b_ms, bound_by=b_by,
                           library_ms=None, launch_floor_ms=k3_case["(28,58,35)"][2])

    # ---- 7. the split LQ solve: backward_pass, then K3 ----
    fns = make_lq_functions(pb.ocp, pb.model.flow_map, scfg.dt, N_NODES, pb.bp,
                            sensitivity="node", flow_batch=pb.model.flow_map_batch)
    times = scfg.dt * torch.arange(N_NODES + 1, dtype=torch.float32, device=dev)
    lq = fns.lq_approximation(traj, times, pb.params, pb.lam, min(scfg.rho, 1.0))
    reduced = levenberg_damp(project_lq(lq, lq.Cx, lq.Du, lq.g_res, scfg.proj_eps)[0], scfg.reg)
    lq_al = levenberg_damp(fns.lq_approximation(traj, times, pb.params, pb.lam, scfg.rho),
                           scfg.reg)
    dx0 = pb.x0 - traj.xs[0]
    split = {}
    rollout.reset_launches()
    for label, L in (("projected nz 21", reduced), ("AL nu 35", lq_al)):
        sol_b = backward_pass(L, scfg.reg_num)
        before = rollout.LAUNCHES
        got = rollout.forward_rollout(L, sol_b, dx0, backend="cuda")
        if rollout.LAUNCHES != before + 1:
            raise AssertionError(f"split solve {label}: K3 launched "
                                 f"{rollout.LAUNCHES - before} times in one call")
        split[label] = (L, sol_b, got)
    k3_launches = rollout.LAUNCHES
    for label, (L, sol_b, got) in split.items():
        e_plain = scaled_err(got, forward_pass(L, sol_b, dx0), K3_TOL["f32"],
                             f"split solve {label} vs forward_pass")
        fused = riccati.riccati_rollout(L, dx0, scfg.reg_num, backend="cuda")
        torch.cuda.synchronize()
        e_k1 = max_err(got, fused, what=f"split solve {label} vs K1", **K1_TOL)
        t_split = cuda_time_ms(lambda: rollout.forward_rollout(
            L, backward_pass(L, scfg.reg_num), dx0, backend="cuda"), 5, warmup=1)
        t_fused = cuda_time_ms(lambda: riccati.riccati_rollout(L, dx0, scfg.reg_num,
                                                               backend="cuda"), 20)
        print(f"split solve {label}: K3 vs forward_pass {e_plain:.3e}, vs K1's fused solve "
              f"{e_k1:.3e} (K1 limit atol 5e-4 rtol 1e-3); backward_pass + K3 "
              f"{t_split:.2f} ms per solve, K1 {t_fused:.3f} ms")
    rows["rollout"]["launches"] = k3_launches

    # ---- 8. the other solver configurations, at full width ----
    def counts():
        return {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES, "K3": rollout.LAUNCHES}

    def expect_exactly(k1, k2, k3=0):
        return lambda n: {"K1": (k1 * n, k1 * n), "K2": (k2 * n, k2 * n), "K3": (k3 * n, k3 * n)}

    def expect_ladder(k1, k2_lq):
        # the two-stage filter ladder: one or two candidate sweeps (3 K2 each)
        return lambda n: {"K1": (k1 * n, k1 * n), "K2": ((k2_lq + 3) * n, (k2_lq + 6) * n),
                          "K3": (0, 0)}

    configs = (
        # name, factory, config fields, sustained solves, launch counts per solve
        ("al+merit", make_sqp_solver, dict(equality_handling="al", line_search="merit"), 4,
         expect_exactly(1, 11)),
        ("parallel_riccati", make_sqp_solver, dict(parallel_riccati=True), 4,
         expect_ladder(0, 3)),
        ("midpoint", make_sqp_solver, dict(sensitivity="midpoint"), 3, expect_ladder(1, 0)),
        ("exact", make_sqp_solver, dict(sensitivity="exact"), 3, expect_ladder(1, 0)),
        ("ddp", make_ddp_solver, dict(equality_handling="al"), 2, expect_exactly(0, 0)),
        ("staged", make_staged_sqp_solver, {}, 4, expect_exactly(1, 10)),
    )
    config_rates = {}
    for cname, factory, fields, n_sus, expect in configs:
        kcfg = SqpSolverConfig(n_nodes=N_NODES, dt=pb.cfg.sqp.dt, **fields)
        pcfg = dataclasses.replace(kcfg, rollout_backend="plain", flow_backend="plain")
        solve_k = factory(pb.ocp, pb.model.flow_map, pb.bp, kcfg, device="cuda")
        solve_p = factory(pb.ocp, pb.model.flow_map, pb.bp, pcfg, device="cuda")

        def run(solve, traj0, lam0):
            out = solve(0.0, pb.x0, traj0, pb.params, lam0)
            return out[0] if isinstance(out, tuple) and not hasattr(out, "traj") else out

        torch.cuda.reset_peak_memory_stats()
        for mod in (riccati, fkvel, rollout):
            mod.reset_launches()
        t0 = time.perf_counter()
        got = run(solve_k, pb.traj, pb.lam)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        c_traj, c_lam = got.traj, got.lam
        t0 = time.perf_counter()
        for _ in range(n_sus):
            s_ = run(solve_k, c_traj, c_lam)
            c_traj, c_lam = s_.traj, s_.lam
        torch.cuda.synchronize()
        rate = n_sus / (time.perf_counter() - t0)
        seen, n = counts(), 1 + n_sus
        for kname, (lo, hi) in expect(n).items():
            if not lo <= seen[kname] <= hi:
                raise AssertionError(f"{cname}: {kname} launched {seen[kname]} times in {n} "
                                     f"solves, expected {lo}..{hi}")
        if cname == "staged":
            staged_report = staged_graphs(torch, riccati, fkvel, pb, kcfg, solve_k, c_traj,
                                          c_lam, card)
        ref = run(solve_p, pb.traj, pb.lam)
        torch.cuda.synchronize()
        errs = []
        for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us),
                           ("lam", got.lam, ref.lam)):
            errs.append(scaled_err([a], [b], SOLVE_TOL, f"{cname} {what} kernels vs plain"))
        if not (np.isfinite(float(got.cost)) and np.isfinite(float(got.g_norm))):
            raise AssertionError(f"{cname}: non-finite cost or g_norm")
        if float(got.step_size) != float(ref.step_size):
            raise AssertionError(f"{cname}: kernels took step {float(got.step_size)}, plain "
                                 f"versions {float(ref.step_size)}")
        config_rates[cname] = rate
        mode = "graphed" if hasattr(solve_k, "sets") else "eager"
        print(f"{cname} ({mode}): cost {float(got.cost):.6g} g_norm {float(got.g_norm):.3e} step "
              f"{float(got.step_size)}; vs plain max|dxs| {errs[0]:.3e} |dus| {errs[1]:.3e} "
              f"|dlam| {errs[2]:.3e}; launches in {n} solves {seen}; first solve "
              f"{t_first:.2f} s; sustained {rate:.3f} it/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB | {card}")
    print(json.dumps({"config_it_per_s": config_rates, "main_path_it_per_s": sustained,
                      "staged": staged_report, "card": card}))

    # ---- 9. the closed loop, both formulations, humanoid23 at N = 28 ----
    loops = closed_loops(torch, riccati, fkvel, rollout, card)
    print(json.dumps({"closed_loop": loops, "card": card}))

    # ---- 10. the MRT host runtime: solver thread + 500 Hz control loop ----
    mrt = mrt_phase(torch, riccati, fkvel, card)
    print(json.dumps({"mrt": mrt, "card": card}))

    # ---- 11. the batched solve ----
    batched = batched_phase(torch, riccati, fkvel, card, rows)
    print(json.dumps({"batched": batched, "card": card}))

    # ---- 12. the 2-D sharded solve on rank meshes ----
    sharded = sharded_phase(torch, fkvel, card, rows)
    print(json.dumps({"sharded": sharded, "card": card}))

    # ---- 13. the launch CLI, as a user runs it ----
    launched = launch_phase(torch, riccati, fkvel, card)
    print(json.dumps({"launch": launched, "card": card}))

    # ---- 14. the bench entry and the scaling report, as a user runs them ----
    benched = bench_phase(torch, riccati, fkvel, card)
    print(json.dumps({"bench": benched, "card": card}))

    # ---- 15. the MuJoCo physics loop, where this machine has mujoco ----
    if importlib.util.find_spec("mujoco") is None:
        print(f"mujoco: {NO_MUJOCO}")
        print(json.dumps({"mujoco": {"skipped": NO_MUJOCO}, "card": card}))
    else:
        physics = mujoco_phase(torch, riccati, fkvel, card)
        print(json.dumps({"mujoco": physics, "card": card}))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launch_floor_ms")
    kernels = [{k: r[k] for k in keys if k in r}
               for r in (rows["riccati"], rows["fkvel"], rows["fkvel_flow"], rows["rollout"],
                         *rows["riccati_batched"], *rows["fkvel_batched"],
                         *rows["fkvel_sharded"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
