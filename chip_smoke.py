#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wb_humanoid_mpc_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives three paths,
all at N = 28 on the 29-DoF `humanoid23` model (nx 58, nu 35, 14 equality
rows), the stance setup of `bench.py`, in float32:

- the main path: warm-started whole-body SQP iterations (projection +
  filter), through K1 (`riccati.cu`) and K2 (`fkvel.cu`);
- the split LQ solve: the sequential `backward_pass` then K3
  (`rollout.cu`), on the main path's projected LQ (nz 21) and on the AL
  path's unprojected one (nu 35), against `forward_pass` and K1's fused solve;
- every other solver configuration (AL + merit, parallel Riccati, midpoint
  and exact sensitivities, DDP, the staged solver), a few warm-started
  solves each, against the same configuration on the plain versions.

Each path checks that its kernels were launched as the configuration
implies, that the result is finite and that it agrees with the plain
versions. Any failure exits non-zero. The last line is the device JSON; the
line before it lists the kernels with their launches, errors, times and
bounds. Without a CUDA card it exits with code 1 and prints no result.
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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

    k3_err = 0.0
    k3_case = {}
    for label, args, tol in (
            ("(28,58,35)", stage_tensors(10, 28, 58, 35), K3_TOL["f32"]),
            ("(28,58,21)", stage_tensors(11, 28, 58, 21), K3_TOL["f32"]),
            ("(15,35,35)", stage_tensors(12, 15, 35, 35), K3_TOL["f32"]),
            ("(7,12,5)", stage_tensors(13, 7, 12, 5), K3_TOL["f32"]),
            ("(28,58,35) batch=4", stage_tensors(14, 28, 58, 35, batch=4), K3_TOL["f32"]),
            ("(28,58,35) f64", stage_tensors(15, 28, 58, 35, dtype=torch.float64),
             K3_TOL["f64"])):
        out_k = rollout.forward_rollout_cuda(*args)
        out_p = rollout.forward_rollout_plain(*args)
        torch.cuda.synchronize()
        err = scaled_err(out_k, out_p, tol, f"K3 {label}")
        t_dev = kernel_device_ms(lambda: rollout.forward_rollout_cuda(*args), 20)
        t_k = cuda_time_ms(lambda: rollout.forward_rollout_cuda(*args), 100)
        t_p = cuda_time_ms(lambda: rollout.forward_rollout_plain(*args), 10)
        k3_case[label] = (t_dev, t_p)
        if "f64" not in label:
            k3_err = max(k3_err, err)
        print(f"K3 rollout {label}: max|kernel-plain| {err:.3e} (limit {tol:g} x max(1, "
              f"max|ref|)); kernel {t_dev * 1e3:.2f} us on the device, {t_k * 1e3:.2f} us per "
              f"call with its wrapper; plain {t_p * 1e3:.1f} us per call")
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
                           library_ms=None)

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in (rows["riccati"], rows["fkvel"], rows["rollout"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
