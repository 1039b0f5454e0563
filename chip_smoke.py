#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wb_humanoid_mpc_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives these paths,
all at N = 28 on the 29-DoF `humanoid23` model (nx 58, nu 35, 14 equality
rows), the stance setup of `bench.py`, in float32:

- the main path: warm-started whole-body SQP iterations (projection +
  filter), through K1 (`riccati.cu`) and K2 (`fkvel.cu`);
- the split LQ solve: the sequential `backward_pass` then K3
  (`rollout.cu`, one thread-block cluster per instance), on the main path's
  projected LQ (nz 21) and on the AL path's unprojected one (nu 35), against
  `forward_pass` and K1's fused solve;
- every other solver configuration (AL + merit, parallel Riccati, midpoint
  and exact sensitivities, DDP, the staged solver), a few warm-started
  solves each, against the same configuration on the plain versions;
- the closed loop of both formulations (`build_*_mpc` + the dummy sim);
- the MRT host runtime of both formulations: `MrtPipeline`'s solver thread
  on the card beside a 500 Hz control loop (replay plant, native seqlock,
  the MRT controller on its own CUDA stream, native `control_tick`);
- the batched solve: B = 8 against 8 unbatched solves and against its plain
  run, a sweep of B up to the largest that fits (at most 256), K1 at a
  leading batch of 8, 64 and that B, and K2 at the sweep's row counts
  (B x 28 and 2 B x 28) at B = 64 and that B;
- the 2-D (batch x horizon) sharded solve, the port's `dryrun_multichip`:
  the walking schedule, 2 SQP iterations, f32 and f64, on a 1x1 mesh
  (`nccl`) and on 1x4 and 2x4 meshes of `gloo` ranks on this one card
  (`parallel/multihost.py::run_ranks`), against `make_batched_solver`, and
  K2 at the sharded path's row counts.

Each path checks that its kernels were launched as the configuration
implies, that the result is finite and that it agrees with the plain
versions. Any failure exits non-zero. The last line is the device JSON; the
line before it lists the kernels with their launches, errors, times and
bounds (and, for K3, the launch floor: an empty kernel of its cluster
grid). Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
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
K1_TOL = dict(rtol=1e-3, atol=5e-4)   # tests/test_ops_riccati.py Mosaic tier
K3_TOL = {"f32": 1e-5, "f64": 1e-12}  # x max(1, max|ref|): tests/test_ops_rollout.py
SOLVE_TOL = 2e-3                      # x max(1, max|ref|): kernels vs plain, whole solves


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
    whole-body, a 1.2 s run with `request_gait("trot")` at t = 0.3 s. The
    first 3 ticks of each stance run are held against the same loop on the
    plain versions; the behaviour checks mirror tests/test_dummy_sim.py."""
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
              f"50 Hz plant / 25 Hz MPC")

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


def _capture_last_launch(module, name: str, store: dict, key, counts: dict | None = None):
    """Wrap `module.name` (a kernel wrapper, looked up at call time by its
    dispatcher) so that it keeps the inputs and outputs of its last launch
    under `key`, or under key(*args) when `key` is a function, and counts the
    launches under that key in `counts`; returns a function that restores
    the wrapper."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        k = key(*args) if callable(key) else key
        store[k] = (args, kwargs, out)
        if counts is not None:
            counts[k] = counts.get(k, 0) + 1
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def mrt_phase(torch, riccati, fkvel, card: str) -> dict:
    """The MRT host runtime at full width: per formulation, a `MrtPipeline`
    whose solver thread solves on the card while a 500 Hz control loop in
    this thread, each tick, pushes an observation from a replay plant (the
    newest policy's state at t + dt), reads the policy through the native
    seqlock and computes torques with the formulation's controller (on its
    own CUDA stream) and with the native `control_tick`. The control clock
    is the wall clock. Whole-body for at least 5 s and 5 policies used by the
    control loop, centroidal for at least 2 s and 3. Before the loop, one
    solve of the solver thread from a fixed observation holds its K1 against
    the plain version; after it, the thread's last K1 and K2 launches are
    launched again (bit-identical) and held against plain."""
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
        # warm: the first solve and controller call of a process are slow;
        # then the controller alone, with no solver thread beside it
        rt.advance(0.0, x0, np.zeros(4))
        warm_pol = rt.policy
        rt.reset()
        ctrl.compute(0.0, x0, None)
        alone_ms = []
        for i in range(50):
            c0 = time.perf_counter()
            ctrl.compute(0.002 * i, x0, warm_pol)
            alone_ms.append((time.perf_counter() - c0) * 1e3)
        torch.cuda.synchronize()

        # the solver thread's K1 on a reproducible input: the one solve of a
        # fresh pipeline from the fixed observation (t = 0, x0)
        probe_cap = {}
        restore = _capture_last_launch(riccati, "riccati_rollout_cuda", probe_cap, "K1")
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
            restore()
        if probe.failed:
            raise AssertionError(f"mrt {form}: the solver failed ({probe.error!r})")
        rt.reset()
        args, kwargs, got = probe_cap["K1"]
        torch.cuda.synchronize()
        e1_fixed, r1_fixed = k1_solver_err(
            got, riccati.riccati_rollout_plain(*args, **kwargs),
            f"mrt {form} K1 (solver thread, fixed observation)")

        record = _recording(rt, riccati, fkvel)
        captured = {}
        restore = [_capture_last_launch(riccati, "riccati_rollout_cuda", captured, "K1"),
                   _capture_last_launch(fkvel, "fkvel_cuda", captured, "K2")]
        pipe = MrtPipeline(rt, nx=x0.shape[0], device="cuda")
        observer = PolicyObserver(pipe)
        starts, work, ctrl_ms, ages, past, tau_err = [], [], [], [], [], 0.0
        policies_seen = set()
        x = x0.copy()
        for mod in (riccati, fkvel):
            mod.reset_launches()
        pipe.start()
        try:
            t_start = time.perf_counter()
            k = 0
            while True:
                wait = t_start + k * period - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                s0 = time.perf_counter()
                starts.append(s0)
                t = s0 - t_start   # the control clock is the wall clock
                pipe.push_observation(t, x, np.zeros(4))
                pol = pipe.get_policy()
                c0 = time.perf_counter()
                action = ctrl.compute(t, x, pol)
                ctrl_ms.append((time.perf_counter() - c0) * 1e3)
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
                    policies_seen.add(pol.t0)
                    tau_n = native.control_tick(
                        pol.xs, pol.us, pol.t0, pol.dt, t + ctrl.lead, q_off, qd_src, qd_off,
                        np.arange(n), action.ff_effort, ctrl.KP, ctrl.KD, ctrl.KP_FIXED,
                        ctrl.KD_FIXED, q, qd)
                    tau_err = max(tau_err, float(np.abs(tau_n - tau).max()
                                                 / max(1.0, float(np.abs(tau).max()))))
                    ages.append(t - pol.t0)
                    past.append(t + ctrl.lead - pol.t0 > horizon)
                    x = np.asarray(pol.evaluate(t + period)[0], dtype=float)   # replay plant
                work.append(time.perf_counter() - s0)
                k += 1
                elapsed = time.perf_counter() - t_start
                if pipe.failed or (elapsed >= seconds and len(policies_seen) >= min_solves):
                    break
                if elapsed > 120.0:
                    raise AssertionError(f"mrt {form}: {len(policies_seen)} policies in 120 s")
        finally:
            pipe.stop(timeout=120.0)
            for r in restore:
                r()
            del rt.advance   # the recording wrapper
        torch.cuda.synchronize()
        launches = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES}
        wall = time.perf_counter() - t_start
        if pipe._thread is not None:
            raise AssertionError(f"mrt {form}: stop() did not join the solver thread")
        if pipe.failed:
            raise AssertionError(f"mrt {form}: the solver failed ({pipe.error!r})")
        if len(policies_seen) < 3:
            raise AssertionError(f"mrt {form}: {len(policies_seen)} policies seen by the "
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
            got = list(got[0]) + list(got[1])
            again = fkvel.fkvel_cuda(*args, **kwargs)
            same_bits["K2"] = all(torch.equal(a, b) for a, b in
                                  zip(got, list(again[0]) + list(again[1])))
            if not same_bits["K2"]:
                raise AssertionError(f"mrt {form}: K2 launched again on the solver thread's "
                                     f"last inputs gives other bits")
            fk_p, vb_p = fkvel.fkvel_plain(*args, **kwargs)
            ref2 = list(fk_p) + list(vb_p)
            e2 = max_err(got, ref2, what=f"mrt {form} K2", **K2_TOL)
            r2 = max(float(((a - b).abs() / (K2_TOL["atol"] + K2_TOL["rtol"] * b.abs())).max())
                     for a, b in zip(got, ref2))
        periods = np.diff(starts) * 1e3
        solve_ms = np.array([r["stats"].solve_time for r in record]) * 1e3
        row = dict(solves=pipe.solve_count, policies_seen=len(policies_seen), ticks=len(starts),
                   wall_s=wall,
                   tick_period_ms_p50=float(np.percentile(periods, 50)),
                   tick_period_ms_p99=float(np.percentile(periods, 99)),
                   tick_period_ms_max=float(periods.max()),
                   overruns=int(sum(w > period for w in work)),
                   controller_ms_p50=float(np.percentile(ctrl_ms, 50)),
                   controller_ms_p99=float(np.percentile(ctrl_ms, 99)),
                   controller_alone_ms_p50=float(np.percentile(alone_ms, 50)),
                   gil_switch_interval_s=sys.getswitchinterval(),
                   policy_age_ms_p50=float(np.percentile(ages, 50)) * 1e3,
                   policy_age_ms_max=float(max(ages)) * 1e3,
                   past_horizon_share=float(np.mean(past)), horizon_s=horizon,
                   solve_ms_p50=float(np.percentile(solve_ms, 50)),
                   sqp_iterations=n_it, k1_per_iteration=k1 / n_it,
                   k2_per_iteration=k2 / n_it, k1_fixed_vs_plain=e1_fixed,
                   k1_fixed_share_of_limit=r1_fixed, k1_last_vs_plain=e1,
                   k1_last_share_of_limit=r1, k2_last_vs_plain=e2, k2_last_share_of_limit=r2,
                   native_vs_controller=tau_err, relaunch_same_bits=same_bits,
                   launches=launches)
        out[form] = row
        print(f"mrt {form}: {row['solves']} solves (p50 {row['solve_ms_p50']:.2f} ms), "
              f"{row['policies_seen']} policies seen by the control loop, "
              f"{row['ticks']} control ticks in {wall:.2f} s; tick period p50 "
              f"{row['tick_period_ms_p50']:.3f} ms p99 {row['tick_period_ms_p99']:.3f} ms max "
              f"{row['tick_period_ms_max']:.3f} ms; {row['overruns']} ticks over 2 ms; "
              f"controller p50 {row['controller_ms_p50']:.3f} ms p99 "
              f"{row['controller_ms_p99']:.3f} ms (alone, no solver thread: p50 "
              f"{row['controller_alone_ms_p50']:.3f} ms; GIL switch interval "
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
    return out


def batched_phase(torch, riccati, fkvel, card: str, rows: dict) -> dict:
    """The batched solve (`make_batched_solver`) at full width, one SQP
    iteration: at B = 8 per instance against 8 unbatched solves and the
    kernel run against the plain run; then `batched_throughput` at B = 1, 8,
    64 and the largest B that fits by the peak memory of B = 8 and 64 (at
    most 256), K1 launched once per batched iteration; K1's device time at
    B = 8, 64 and the largest B against its bound; K2's last launch at each
    of the sweep's row counts at B = 64 and the largest B against its plain
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

    k2_caps = {}   # batch -> {rows: (args, kwargs, outputs) of the sweep's last K2 launch}

    def sweep(batch):
        for mod in (riccati, fkvel):
            mod.reset_launches()
        n_rounds = 5 if batch <= 8 else 3
        caps, by_rows = {}, {}
        restore = _capture_last_launch(fkvel, "fkvel_cuda", caps,
                                       lambda model, q, v: q.shape[0], by_rows)
        try:
            r = batched_throughput(batch, N_NODES, n_rounds=n_rounds, device="cuda")
        finally:
            restore()
        n_it = n_rounds + 1
        if riccati.LAUNCHES != n_it or not 6 * n_it <= fkvel.LAUNCHES <= 9 * n_it:
            raise AssertionError(f"batched B={batch}: K1 {riccati.LAUNCHES}, K2 "
                                 f"{fkvel.LAUNCHES} launches in {n_it} batched iterations")
        if sum(by_rows.values()) != fkvel.LAUNCHES:
            raise AssertionError(f"batched B={batch}: K2 launches by rows {by_rows}, "
                                 f"{fkvel.LAUNCHES} counted")
        if not r["finite"]:
            raise AssertionError(f"batched B={batch}: non-finite cost")
        k2_caps[batch] = caps
        r.update(k1_launches=riccati.LAUNCHES, k2_launches=fkvel.LAUNCHES, iterations=n_it,
                 k2_launches_by_rows=dict(sorted(by_rows.items())))
        print(f"batched B={batch}: {r['instances_per_s']:.2f} instances/s, "
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

    # K2 at the batched solve's row counts: the sweep's last launch at each
    # row count, B = 64 and the largest B, against the plain version on the
    # same inputs
    k2_rows = []
    for batch in sorted({64, b_max}):
        for n_rows, (args, kwargs, got) in sorted(k2_caps[batch].items()):
            model_, q, v = args
            got = list(got[0]) + list(got[1])
            fk_p, vb_p = fkvel.fkvel_plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max_err(got, list(fk_p) + list(vb_p), what=f"K2 batch={batch} rows={n_rows}",
                          **K2_TOL)
            t_dev = kernel_device_ms(lambda: fkvel.fkvel_cuda(*args, **kwargs), 20)
            t_p = cuda_time_ms(lambda: fkvel.fkvel_plain(*args, **kwargs), 3, warmup=1)
            nbytes, ops = fkvel_work(n_rows, model_.n_joints, q.element_size())
            b_ms, b_by = bound_ms(nbytes, ops)
            launches = report[batch]["k2_launches_by_rows"][n_rows]
            k2_rows.append(dict(name=f"fkvel batch={batch} rows={n_rows}", route="cuda",
                                source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                                replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                                launches=launches, max_abs_err=err, ms=t_dev, plain_ms=t_p,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
            print(f"K2 fkvel batch={batch} rows={n_rows} (the sweep's last launch of that "
                  f"size, {launches} launches of it in {report[batch]['iterations']} "
                  f"iterations): max|kernel-plain| {err:.3e} (atol {K2_TOL['atol']} rtol "
                  f"{K2_TOL['rtol']}); kernel {t_dev * 1e3:.2f} us on the device; plain "
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


def sharded_rank(cases) -> list:
    """One rank of the `sharded` phase: `dryrun.sharded_sqp_case` for each
    case, K2's last launch at each row count kept; rank (0, 0) returns those
    launches' inputs and outputs as numpy, for the parent to hold against the
    plain version."""
    from wb_humanoid_mpc_tpu_torch.ops import fkvel
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import sharded_sqp_case

    out = []
    for case in cases:
        caps = {}
        restore = _capture_last_launch(fkvel, "fkvel_cuda", caps, lambda model, q, v: q.shape[0])
        try:
            r = sharded_sqp_case(**case)
        finally:
            restore()
        r["k2_last"] = {} if r["coords"] != (0, 0) else {
            rows: ([a.cpu().numpy() for a in args[1:]],
                   [t.cpu().numpy() for t in list(got[0]) + list(got[1])])
            for rows, (args, _, got) in caps.items()}
        out.append(r)
    return out


def sharded_phase(torch, fkvel, card: str, rows: dict, device: str = "cuda") -> dict:
    """The 2-D (batch x horizon) sharded SQP, the port's `dryrun_multichip`:
    humanoid23 at N = 28, the walking schedule, B = 2 n_dp instances, 2 SQP
    iterations, f32 and f64, on the meshes of SHARDED_MESHES (`nccl` for the
    single rank; `gloo` for several ranks on the one card, as NCCL refuses
    two ranks on one GPU). Every rank's whole solution against
    `make_batched_solver` on the card (SHARDED_GATE and the tighter
    SHARDED_LIMIT, the same steps), K2's
    launches per rank per iteration against the plan, the wall time of an
    iteration (f32) and the collectives an iteration; K2's last launch at
    each of the path's row counts on the 1x1 and 2x4 meshes against its plain
    version. Adds K2's sharded rows."""
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, load_wb_model
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import walking_problem
    from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig

    robot = load_wb_model(ASSETS / "humanoid23")[1].robot
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
                      timed_solves=2 if dt == "float32" else 0) for dt in SHARDED_GATE]
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_rank, world, backend, device, cases, timeout_s=900.0)
        wall = time.perf_counter() - t0
        for k, dt in enumerate(SHARDED_GATE):
            outs = [r[k] for r in ranks]
            o = next(r for r in outs if r["coords"] == (0, 0))
            what = f"sharded {label} ({backend}) {dt}"
            for r in outs:
                for key in ("xs", "us", "cost", "step_size"):
                    if not np.array_equal(r[key], o[key]):
                        raise AssertionError(f"{what}: rank {r['coords']} returned another {key}")
                if r["k2_launches"] != K2_PER_SHARDED_ITERATION * SHARDED_ITERS:
                    raise AssertionError(f"{what}: rank {r['coords']} launched K2 "
                                         f"{r['k2_launches']} times in {SHARDED_ITERS} "
                                         f"iterations, the plan says "
                                         f"{K2_PER_SHARDED_ITERATION} an iteration")
            if not (np.isfinite(o["xs"]).all() and np.isfinite(o["cost"]).all()):
                raise AssertionError(f"{what}: non-finite result")
            ref_xs, ref_steps = refs[(B, dt)]
            err = float(np.abs(o["xs"] - ref_xs).max())
            limit = SHARDED_LIMIT[dt] * max(1.0, float(np.abs(ref_xs).max()))
            if not err < min(SHARDED_GATE[dt], limit):
                raise AssertionError(f"{what}: max |dxs| vs make_batched_solver {err:.3e}, "
                                     f"gate {SHARDED_GATE[dt]}, limit {limit:.3e}")
            if not np.array_equal(o["step_size"], ref_steps):
                raise AssertionError(f"{what}: steps {o['step_size']}, batched {ref_steps}")
            coll = {c: (n - 2 * (c == "all_gather")) / SHARDED_ITERS
                    for c, n in o["collectives"].items()}
            ms = [r["ms_per_iteration"] for r in outs]
            report[f"{label} {dt}"] = dict(
                backend=backend, ranks=world, batch=B, max_abs_dxs=err, dxs_limit=limit,
                steps=o["step_size"].tolist(), k2_per_rank=o["k2_launches"],
                collectives_per_iteration=coll, first_solve_s=max(r["first_s"] for r in outs),
                ms_per_iteration=None if ms[0] is None else max(ms),
                ms_per_iteration_rank0=o["ms_per_iteration"], spawn_and_run_s=wall)
            print(f"sharded {label} {backend} {dt}: {world} rank(s), B = {B}; max|dxs| vs "
                  f"make_batched_solver {err:.3e} (gate {SHARDED_GATE[dt]}, limit "
                  f"{limit:.3e}); steps "
                  f"{o['step_size'].tolist()} (batched the same); K2 "
                  f"{o['k2_launches']} launches on every rank in {SHARDED_ITERS} iterations; "
                  f"collectives per iteration on each rank {coll} (+2 all_gather at the end); "
                  f"first solve {report[f'{label} {dt}']['first_solve_s']:.2f} s"
                  + ("" if ms[0] is None else
                     f"; {max(ms):.2f} ms per sharded SQP iteration (slowest rank; rank 0 "
                     f"{o['ms_per_iteration']:.2f})") + f"; spawn + run {wall:.1f} s | {card}")
            if dt != "float32" or label not in ("1x1", "2x4"):
                continue
            # K2 at this mesh's row counts: the path's last launch of each size
            for n_rows, (args, got) in sorted(o["k2_last"].items()):
                q, v = (torch.as_tensor(a, device=device) for a in args)
                got = [torch.as_tensor(a, device=device) for a in got]
                fk_p, vb_p = fkvel.fkvel_plain(robot, q, v)
                torch.cuda.synchronize()
                err = max_err(got, list(fk_p) + list(vb_p), what=f"K2 sharded {label} "
                              f"rows={n_rows}", **K2_TOL)
                t_dev = kernel_device_ms(lambda: fkvel.fkvel_cuda(robot, q, v), 20)
                t_p = cuda_time_ms(lambda: fkvel.fkvel_plain(robot, q, v), 3, warmup=1)
                nbytes, ops = fkvel_work(n_rows, robot.n_joints, q.element_size())
                b_ms, b_by = bound_ms(nbytes, ops)
                launches = o["flow_batch_calls"][n_rows]
                k2_rows.append(dict(name=f"fkvel sharded {label} rows={n_rows}", route="cuda",
                                    source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                                    replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                                    launches=launches, max_abs_err=err, ms=t_dev, plain_ms=t_p,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
                print(f"K2 fkvel sharded {label} rows={n_rows} (rank 0's last launch of that "
                      f"size, {launches} of its launches): max|kernel-plain| {err:.3e}; kernel "
                      f"{t_dev * 1e3:.2f} us on the device; plain {t_p * 1e3:.1f} us per call; "
                      f"bound {b_ms * 1e3:.4f} us ({b_by}), {100 * b_ms / t_dev:.2f} % of it "
                      f"| {card}")
    if not k2_rows:
        raise AssertionError("sharded: no K2 launch was kept")
    rows["fkvel_sharded"] = k2_rows
    return report


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
          f"n_eq {pb.ocp.n_eq} N {N_NODES}, stance, f32")

    fkvel.reset_launches()
    riccati.reset_launches()
    t0 = time.perf_counter()
    sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
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
          f"{launches['riccati']}, K2 {launches['fkvel']}")
    print(f"main path: sustained {sustained:.2f} SQP it/s, per-call p50 {p50 * 1e3:.2f} ms "
          f"| {card}")

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
    rows["fkvel"]["launches"] = launches["fkvel"]

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
            _, phases = solve_k(0.0, pb.x0, c_traj, pb.params, c_lam)
            if min(phases) < 0:
                raise AssertionError(f"staged: negative phase time {phases}")
            print(f"staged: phase seconds of one solve {dict(phases._asdict())}")
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
        print(f"{cname}: cost {float(got.cost):.6g} g_norm {float(got.g_norm):.3e} step "
              f"{float(got.step_size)}; vs plain max|dxs| {errs[0]:.3e} |dus| {errs[1]:.3e} "
              f"|dlam| {errs[2]:.3e}; launches in {n} solves {seen}; first solve "
              f"{t_first:.2f} s; sustained {rate:.3f} it/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB | {card}")
    print(json.dumps({"config_it_per_s": config_rates, "main_path_it_per_s": sustained,
                      "card": card}))

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launch_floor_ms")
    kernels = [{k: r[k] for k in keys if k in r}
               for r in (rows["riccati"], rows["fkvel"], rows["rollout"],
                         *rows["riccati_batched"], *rows["fkvel_batched"],
                         *rows["fkvel_sharded"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
