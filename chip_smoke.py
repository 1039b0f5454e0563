#!/usr/bin/env python3
"""The kernel harness of the PyTorch / CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wb_humanoid_mpc_tpu_torch/csrc/`,
prints the card's line and the `ptxas` lines of the build, then holds each
kernel, alone, against its plain PyTorch version and times it, at every
shape of the kernel table in PERF.md:

- K2 (`fkvel.cu`, `fkvel_cuda`), the FK + velocity tree pass of humanoid23:
  at the rows of a whole-body solve of 28 nodes (28, 2 x 28, 6 x 28 and the
  merit search's 8 candidates, 8 x 28), in f32, and at 28 and 224 in f64;
- K2's flow variant (`flow_map_cuda`, the whole-body flow map in one
  launch): at the rows of a solve of 29 nodes (RK4 tail 29, top-2 sweep 58,
  lower ladder 174), near a standing pose with stance wrenches;
- K1 (`riccati.cu`), the fused Riccati solve and rollout: at (N, nx, nu) =
  (28, 58, 21), with Quu spanning a factor 100, a batch of 4, (28, 58, 35),
  (28, 58, 21) in f64, and at the shapes the benchmark's cells run it:
  (60, 35, 21) for cen-walk and (29, 58, 21) for wb-walk;
- K3 (`rollout.cu`), the forward rollout, one thread-block cluster an
  instance: at (28, 58, 35), (28, 58, 21), (15, 35, 35), (7, 12, 5), a
  batch of 4, and (28, 58, 35) in f64 (a ring of stage slots), each beside
  the launch floor of its cluster grid (`tools/launch_floor.py`: an empty
  kernel);
- the shapes of the batched and sharded solves: K1 at a leading batch of 8,
  64 and 256 at (28, 58, 21); K2 and its flow variant at the batched
  solve's rows (B x 28, 2 B x 28 and 6 B x 28 at B = 64 and 256: 1,792 to
  43,008) and at a rank's rows of the sharded solve (16 and 128 on the 2x4
  mesh, 58 and 464 on the 1x1). These rows are timed alone on seeded
  inputs, not as the last launch of a batched or sharded solve's replay.

Each launch is held against the plain version on the same inputs (K1_TOL,
K2_TOL, FLOW_TOL against the plain flow map in float64, K3_TOL; K2 in f64
at F64_TOL); K3 must also give the same bits twice. Each is timed alone by
`kernel_device_ms` (launches queued behind a sleep kernel), beside a call
with its host wrapper, the plain version's call, and the bound of its work
(`riccati_work`, `fkvel_work`, `fkvel_flow_work`, `rollout_work`) at the
card's published peaks (`bound_ms`). A row whose check fails prints
`FAILED` and the harness goes on to the other rows, so that one failing
shape still leaves the table of every other; it exits non-zero if any
failed. The line before the last is every row as JSON (`{"kernels":
[...]}`, each with `within_tolerance`), the last says whether every row
passed and names the device. Without a CUDA card it exits with code 1
and prints no result.

The solvers, loops and runtimes built on these kernels are checked on the
card by `python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py`;
their end-to-end numbers come from `mpcbench/`.
"""

from __future__ import annotations

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
K2_TOL = dict(rtol=1e-4, atol=5e-6)   # the Mosaic tolerance of tests/test_ops_fkvel.py
# K2's flow variant against the plain flow map in float64 on the same inputs:
# the flow map's float32 tolerance of tests/test_torch_fkvel.py
FLOW_TOL = dict(rtol=2e-4, atol=2e-5)
K1_TOL = dict(rtol=1e-3, atol=5e-4)   # tests/test_ops_riccati.py Mosaic tier
K3_TOL = {"f32": 1e-5, "f64": 1e-12}  # x max(1, max|ref|): tests/test_ops_rollout.py
F64_TOL = dict(rtol=1e-9, atol=1e-9)  # K2 in float64, as tools/compare_k2.py holds it

# The rows of one K2 launch on each path of the kernel table
SOLVE_ROWS = (28, 2 * 28, 6 * 28, 8 * 28)   # a whole-body solve of 28 nodes
FLOW_ROWS = (29, 2 * 29, 6 * 29)            # of 29 nodes: RK4 tail, top-2 sweep, lower ladder
BATCHED_ROWS = tuple(k * B * 28 for B in (64, 256) for k in (1, 2, 6))
SHARDED_ROWS = {16: "2x4", 58: "1x1", 128: "2x4", 464: "1x1"}   # a rank's rows, by mesh
K1_BATCHES = (8, 64, 256)                   # K1's leading batch in the batched solve

FAILURES: list[str] = []   # the checks that failed, each its message

KERNELS = {   # a kernel of the table: (its source, the TPU kernel it replaces)
    "K1": ("wb_humanoid_mpc_tpu_torch/csrc/riccati.cu", "wb_humanoid_mpc_tpu/ops/riccati.py:129"),
    "K2": ("wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu", "wb_humanoid_mpc_tpu/ops/fkvel.py:235"),
    "K2 flow": ("wb_humanoid_mpc_tpu_torch/csrc/fkvel.cu", "wb_humanoid_mpc_tpu/ops/fkvel.py:235"),
    "K3": ("wb_humanoid_mpc_tpu_torch/csrc/rollout.cu", "wb_humanoid_mpc_tpu/ops/rollout.py:65"),
}


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


def bound_ms(nbytes: float, ops: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take for (bytes, operations), and which
    of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fail(message: str) -> None:
    """Print a failed check and keep it in FAILURES; the harness goes on."""
    FAILURES.append(message)
    print(f"FAILED: {message}", flush=True)


def checked(check, got, ref, what: str, **tol) -> tuple[float, bool]:
    """(max |got - ref|, whether `check` held) for a check that raises where
    the error is beyond its tolerance (`max_err`, `scaled_err`)."""
    try:
        return check(got, ref, what=what, **tol), True
    except AssertionError as e:
        fail(str(e))
        return max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref)), False


def measure(kernel: str, label: str, check: tuple[float, bool], launch, plain, work: tuple,
            itemsize: int, n: int, n_plain: int, note: str = "", **fields) -> dict:
    """Time one shape of a kernel (`launch`, one launch) and its plain
    version, print its line of the table and return its row: its check (the
    largest error and whether it held), the device time of a launch alone,
    of a call with its wrapper, of a plain call, and the bound of `work`
    (bytes, operations)."""
    err, held = check
    t_dev = kernel_device_ms(launch, n)
    t_k = cuda_time_ms(launch, 4 * n)
    t_p = cuda_time_ms(plain, n_plain, warmup=1)
    nbytes, ops = work
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_F32_FLOPS if itemsize == 4 else PEAK_F64_FLOPS)
    print(f"{kernel} {label}: max|kernel-plain| {err:.3e}; kernel {t_dev * 1e3:.2f} us on the "
          f"device, {t_k * 1e3:.2f} us a call with its wrapper; plain {t_p * 1e3:.1f} us a "
          f"call; bound {b_ms * 1e3:.4f} us ({b_by}: {nbytes / 1e3:.1f} KB, {ops / 1e6:.3f} "
          f"MFLOP), {100 * b_ms / t_dev:.3f} % of it{note}", flush=True)
    source, replaces = KERNELS[kernel]
    return dict(name=kernel, shape=label, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, within_tolerance=held, ms=t_dev, wrapper_ms=t_k, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **fields)


def fk_rows(torch, fkvel, robot, dev) -> list:
    """K2 at the solve's rows (f32, and f64 at 28 and 224), the batched
    solve's and the sharded solve's (f32)."""
    cases = ([(B, "", torch.float32) for B in SOLVE_ROWS]
             + [(B, " f64", torch.float64) for B in (SOLVE_ROWS[0], SOLVE_ROWS[-1])]
             + [(B, " (batched)", torch.float32) for B in BATCHED_ROWS]
             + [(B, f" (sharded {mesh})", torch.float32) for B, mesh in SHARDED_ROWS.items()])
    rows = []
    for B, where, dtype in cases:
        rng = np.random.default_rng(B)
        q = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.3, dtype=dtype, device=dev)
        v = torch.as_tensor(rng.normal(size=(B, robot.nq)) * 0.5, dtype=dtype, device=dev)
        fk_k, vb_k = fkvel.fkvel_cuda(robot, q, v)
        fk_p, vb_p = fkvel.fkvel_plain(robot, q, v)
        torch.cuda.synchronize()
        label = f"rows={B}{where}"
        err = checked(max_err, list(fk_k) + list(vb_k), list(fk_p) + list(vb_p), f"K2 {label}",
                      **(K2_TOL if dtype == torch.float32 else F64_TOL))
        size = q.element_size()
        rows.append(measure("K2", label, err, lambda: fkvel.fkvel_cuda(robot, q, v),
                            lambda: fkvel.fkvel_plain(robot, q, v),
                            fkvel_work(B, robot.n_joints, size), size, n=50,
                            n_plain=20 if B <= 224 else 3))
    return rows


def flow_rows(torch, fkvel, model, dev) -> list:
    """K2's flow variant at the 29-node solve's rows, the batched solve's and
    the sharded solve's (f32), against the plain flow map in float64."""
    robot, n_c = model.robot, len(model.contact_frames)
    cases = ([(B, "") for B in FLOW_ROWS] + [(B, " (batched)") for B in BATCHED_ROWS]
             + [(B, f" (sharded {mesh})") for B, mesh in SHARDED_ROWS.items()])
    rows = []
    for B, where in cases:
        rng = np.random.default_rng(B + 1)
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
        ref = model.flow_map_batch(None, xs.double(), us.double(), backend="plain")
        torch.cuda.synchronize()
        label = f"rows={B}{where}"
        err = checked(max_err, [got.double()], [ref], f"K2 flow {label} vs plain in float64",
                      **FLOW_TOL)
        rows.append(measure("K2 flow", label, err, lambda: fkvel.flow_map_cuda(model, xs, us),
                            lambda: model.flow_map_batch(None, xs, us, backend="plain"),
                            fkvel_flow_work(B, robot.n_joints, n_c, 4), 4, n=50,
                            n_plain=20 if B <= 174 else 3))
    return rows


def k1_rows(torch, riccati, dev) -> list:
    """K1 at the main path's and the AL path's shapes, in f64, at the
    benchmark cells' shapes and at the batched solve's leading batches; beside each, the one-SM floor (one
    instance's operations at one SM's share of the peak) times its waves."""
    cases = ([("(28,58,21)", 7, (28, 58, 21), {}),
              ("(28,58,21) quu_span=100", 8, (28, 58, 21), dict(quu_span=100.0)),
              ("(28,58,21) batch=4", 9, (28, 58, 21), dict(batch=4)),
              ("(28,58,35)", 16, (28, 58, 35), {}),
              ("(28,58,21) f64", 17, (28, 58, 21), dict(dtype=np.float64)),
              ("(60,35,21) cen-walk", 18, (60, 35, 21), {}),
              ("(29,58,21) wb-walk", 19, (29, 58, 21), {})]
             + [(f"(28,58,21) batch={b}", 100 + b, (28, 58, 21), dict(batch=b))
                for b in K1_BATCHES])
    rows = []
    for label, seed, (N, nx, nu), kw in cases:
        rng = np.random.default_rng(seed)
        batch, dtype = kw.get("batch"), kw.get("dtype", np.float32)
        parts = [riccati.random_lq_data(rng, N, nx, nu, dtype=dtype,
                                        quu_span=kw.get("quu_span", 1.0))
                 for _ in range(batch or 1)]
        args = [torch.as_tensor(np.stack([p[k] for p in parts]) if batch else parts[0][k],
                                device=dev)
                for k in ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]
        out_k = riccati.riccati_rollout_cuda(*args, reg=1e-8)
        out_p = riccati.riccati_rollout_plain(*args, reg=1e-8)
        torch.cuda.synchronize()
        err = checked(max_err, out_k, out_p, f"K1 {label}", **K1_TOL)
        size = args[0].element_size()
        peak = PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS
        waves = -(-(batch or 1) // N_SMS)
        sm_ms = waves * riccati_work(1, N, nx, nu, size)[1] / (peak / N_SMS) * 1e3
        big = (batch or 1) > 8
        rows.append(measure("K1", label, err,
                            lambda: riccati.riccati_rollout_cuda(*args, reg=1e-8),
                            lambda: riccati.riccati_rollout_plain(*args, reg=1e-8),
                            riccati_work(batch or 1, N, nx, nu, size), size,
                            n=10 if big else 20, n_plain=3 if big else 10,
                            note=f"; one-SM floor x {waves} wave(s) {sm_ms * 1e3:.1f} us",
                            one_sm_floor_ms=sm_ms))
    return rows


def k3_rows(torch, rollout, launch_floor, dev) -> list:
    """K3 at its shapes, its launch plan and, beside it, the launch floor of
    the same cluster grid; two launches on the same inputs must agree bit
    for bit."""
    empty_lib = launch_floor.build()
    cases = (("(28,58,35)", 10, (28, 58, 35), torch.float32, None),
             ("(28,58,21)", 11, (28, 58, 21), torch.float32, None),
             ("(15,35,35)", 12, (15, 35, 35), torch.float32, None),
             ("(7,12,5)", 13, (7, 12, 5), torch.float32, None),
             ("(28,58,35) batch=4", 14, (28, 58, 35), torch.float32, 4),
             ("(28,58,35) f64 ring", 15, (28, 58, 35), torch.float64, None))
    rows = []
    for label, seed, (N, nx, nu), dtype, batch in cases:
        rng = np.random.default_rng(seed)
        parts = [rollout.random_stage_data(rng, N, nx, nu, dtype=np.float64)
                 for _ in range(batch or 1)]
        args = [torch.as_tensor(np.stack([q[k] for q in parts]) if batch else parts[0][k],
                                dtype=dtype, device=dev)
                for k in ("A", "B", "d", "K", "k", "dx0")]
        plan = rollout.rollout_plan(N, nx, nu, dtype)
        out_k = rollout.forward_rollout_cuda(*args)
        out_p = rollout.forward_rollout_plain(*args)
        again = rollout.forward_rollout_cuda(*args)
        torch.cuda.synchronize()
        tol = K3_TOL["f32" if dtype == torch.float32 else "f64"]
        err = checked(scaled_err, out_k, out_p, f"K3 {label}", tol=tol)
        if not all(torch.equal(a, b) for a, b in zip(out_k, again)):
            fail(f"K3 {label}: two launches on the same inputs differ")
            err = (err[0], False)
        t_floor = kernel_device_ms(launch_floor.empty_launcher(
            empty_lib, batch or 1, plan["cluster"], plan["threads"], plan["smem_bytes"]), 20)
        size = args[0].element_size()
        rows.append(measure(
            "K3", label, err, lambda: rollout.forward_rollout_cuda(*args),
            lambda: rollout.forward_rollout_plain(*args),
            rollout_work(batch or 1, N, nx, nu, size), size, n=20, n_plain=10,
            note=(f"; launch floor {t_floor * 1e3:.2f} us; cluster {plan['cluster']}, "
                  f"{plan['slots']} stage slots and {plan['smem_bytes']} shared bytes a CTA, "
                  f"cudaOccupancyMaxActiveClusters {plan['max_active_clusters']}"),
            launch_floor_ms=t_floor))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, load_wb_model
    from wb_humanoid_mpc_tpu_torch.ops import _lib, fkvel, riccati, rollout
    from wb_humanoid_mpc_tpu_torch.tools import launch_floor
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    # ---- 1. the card ----
    dev = resolve_device("cuda")   # TF32 off, as on the solver's path
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

    # ---- 3. K2 and its flow variant, 4. K1, 5. K3 ----
    model = load_wb_model(ASSETS / "humanoid23")[1]
    rows = fk_rows(torch, fkvel, model.robot, dev)
    rows += flow_rows(torch, fkvel, model, dev)
    rows += k1_rows(torch, riccati, dev)
    rows += k3_rows(torch, rollout, launch_floor, dev)

    print(json.dumps({"kernels": rows, "card": card}))
    for failure in FAILURES:
        print(f"FAILED: {failure}")
    print(json.dumps({"ok": not FAILURES, "device": {"platform": "gpu", "kind": name,
                                                    "count": torch.cuda.device_count()}}))
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
