#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wb_humanoid_mpc_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives the main path:
warm-started whole-body SQP iterations at N = 28 on the 29-DoF `humanoid23`
model (nx 58, nu 35, 14 equality rows), the stance setup of `bench.py`. It
checks that every kernel was launched on that path, that the result is finite
and that it agrees with the same solve run on the plain versions. Any failure
exits non-zero. The last line is the device JSON; the line before it lists the
kernels with their launches, errors, times and bounds. Without a CUDA card it
exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks: 67 TFLOP/s float32 outside the tensor cores,
# 3.35 TB/s device memory (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
N_NODES = 28
K2_TOL = dict(rtol=1e-4, atol=5e-6)   # the Mosaic tolerance of tests/test_ops_fkvel.py
K1_TOL = dict(rtol=1e-3, atol=5e-4)   # tests/test_ops_riccati.py Mosaic tier


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


def kernel_device_ms(fn, n: int, kernel: str) -> float:
    """Mean device time of one launch of the CUDA kernel whose name contains
    `kernel`, over n calls of fn() under torch.profiler: the kernel alone,
    without the host time of its wrapper (which, for a kernel of a few
    microseconds, is what back-to-back CUDA-event timing measures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs = [ev.time_range.elapsed_us() for ev in prof.events()
            if ev.device_type.name == "CUDA" and kernel in ev.name]
    if len(durs) != n:
        raise AssertionError(f"profiler saw {len(durs)} launches of {kernel}, expected {n}")
    return sum(durs) / n / 1e3


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
    from wb_humanoid_mpc_tpu_torch.ops import _lib, fkvel, riccati
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
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
    for B in (28, 2 * 28, 6 * 28):
        q = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.3, dtype=torch.float32, device=dev)
        v = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.5, dtype=torch.float32, device=dev)
        fk_k, vb_k = fkvel.fkvel_cuda(robot, q, v)
        fk_p, vb_p = fkvel.fkvel_plain(robot, q, v)
        torch.cuda.synchronize()
        err = max_err(list(fk_k) + list(vb_k), list(fk_p) + list(vb_p), what=f"K2 B={B}",
                      **K2_TOL)
        k2_err = max(k2_err, err)
        t_dev = kernel_device_ms(lambda: fkvel.fkvel_cuda(robot, q, v), 50, "fkvel_kernel")
        t_k = cuda_time_ms(lambda: fkvel.fkvel_cuda(robot, q, v), 200)
        t_p = cuda_time_ms(lambda: fkvel.fkvel_plain(robot, q, v), 20)
        k2_ms[B] = (t_dev, t_p)
        print(f"K2 fkvel B={B}: max|kernel-plain| {err:.3e}; kernel {t_dev * 1e3:.2f} us on the "
              f"device, {t_k * 1e3:.2f} us per call with its wrapper; plain {t_p * 1e3:.1f} us "
              f"per call")
    nbytes, ops = fkvel_work(28, robot.n_joints, 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    rows["fkvel"] = dict(name="fkvel", route="cuda",
                         source="wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu",
                         replaces="wb_humanoid_mpc_tpu/ops/fkvel.py:235",
                         max_abs_err=k2_err, ms=k2_ms[28][0], plain_ms=k2_ms[28][1],
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- 4. K1: fused Riccati + rollout ----
    def lq_tensors(seed, N, nx, nu, quu_span=1.0, batch=None):
        r = np.random.default_rng(seed)
        if batch is None:
            data = riccati.random_lq_data(r, N, nx, nu, quu_span=quu_span)
        else:
            parts = [riccati.random_lq_data(r, N, nx, nu, quu_span=quu_span)
                     for _ in range(batch)]
            data = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        return [torch.as_tensor(data[k], device=dev) for k in
                ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]

    k1_err = 0.0
    k1_case = {}
    for label, args in (("(28,58,21)", lq_tensors(7, 28, 58, 21)),
                        ("(28,58,21) quu_span=100", lq_tensors(8, 28, 58, 21, quu_span=100.0)),
                        ("(28,58,21) batch=4", lq_tensors(9, 28, 58, 21, batch=4))):
        out_k = riccati.riccati_rollout_cuda(*args, reg=1e-8)
        out_p = riccati.riccati_rollout_plain(*args, reg=1e-8)
        torch.cuda.synchronize()
        err = max_err(out_k, out_p, what=f"K1 {label}", **K1_TOL)
        t_dev = kernel_device_ms(lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8), 20,
                                 "riccati_rollout_kernel")
        t_k = cuda_time_ms(lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8), 100)
        t_p = cuda_time_ms(lambda: riccati.riccati_rollout_plain(*args, reg=1e-8), 10)
        k1_case[label] = (t_dev, t_p)
        if label == "(28,58,21)":
            k1_err = err
        print(f"K1 riccati {label}: max|kernel-plain| {err:.3e}; kernel {t_dev * 1e3:.1f} us on "
              f"the device, {t_k * 1e3:.1f} us per call with its wrapper; plain "
              f"{t_p * 1e3:.1f} us per call")
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
        print(f"main path vs plain versions: max|d{what}| {err:.3e} (limit {2e-3 * scale:.3e})")
        if not err <= 2e-3 * scale:
            raise AssertionError(f"main path: kernels and plain versions disagree on {what}")
    if float(got.step_size) != float(ref.step_size):
        raise AssertionError("main path: kernels and plain versions took different steps")

    rows["riccati"]["launches"] = launches["riccati"]
    rows["fkvel"]["launches"] = launches["fkvel"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in (rows["riccati"], rows["fkvel"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
