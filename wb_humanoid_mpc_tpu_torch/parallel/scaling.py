"""Batch-scaling benchmark harness.

PyTorch counterpart of `batched_throughput` and `scaling_report` in
`wb_humanoid_mpc_tpu/parallel/scaling.py`: batched SQP iterations/s at
increasing batch sizes, on one device or across the `dp` axis of a rank
mesh (`shard_batched_solver`). The problem is `bench.py`'s stance
problem built by `interface.build_wb_problem` on `assets/humanoid23`; each
instance starts from its own perturbed x0.
Errors are not caught: a batch that does not fit fails the report.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, WBProblem, build_wb_problem
from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver, shard_batched_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory


def batched_inputs(pb: WBProblem, batch: int, seed: int = 0, spread: float = 0.005):
    """(x0 [B, nx], warm start, params, multipliers) for `batch` instances of
    `pb`: x0 plus spread * N(0, 1) noise from `seed` (JAX's harness draws the
    same), everything else the problem's own, repeated."""
    B = batch
    noise = np.random.default_rng(seed).standard_normal((B, pb.x0.shape[0])) * spread
    x0s = pb.x0 + torch.as_tensor(noise, dtype=pb.x0.dtype, device=pb.x0.device)

    def rep(a):
        return a.expand(B, *a.shape).contiguous()

    traj = Trajectory(xs=rep(pb.traj.xs), us=rep(pb.traj.us))
    params = type(pb.params)(*(rep(a) for a in pb.params))
    return x0s, traj, params, rep(pb.lam)


def batched_throughput(batch: int, n_nodes: int = 28, n_rounds: int = 30, seed: int = 0, *,
                       device="cuda", dtype=torch.float32, mesh=None) -> dict:
    """Instances/s and SQP iterations/s of one batched solve of `batch`
    instances, one SQP iteration each: a first solve, then `n_rounds`
    warm-started rounds queued back to back with one synchronization at the
    end (the MRT pipelining mode). With a rank `mesh`, every rank of it
    calls this: the batch is split over its `dp` axis (`shard_batched_solver`)
    and `devices` counts its ranks, as JAX's `len(jax.devices())`."""
    pb = build_wb_problem(ASSETS / "humanoid23", n_nodes, device=device, dtype=dtype)
    dev = pb.x0.device
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    x0s, traj, params, lam = batched_inputs(pb, batch, seed)
    if mesh is None:
        solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=dev)
    else:
        sharded, shard = shard_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, mesh,
                                              device=dev)
        x0s = shard(x0s)

        def solve(t0, x0, traj_, params_, lam_):
            # the warm start comes back whole: each rank keeps its rows
            return sharded(t0, x0, shard(traj_), shard(params_), shard(lam_))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sol = solve(0.0, x0s, traj, params, lam)
    sync()
    traj, lam = sol.traj, sol.lam
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        sol = solve(0.0, x0s, traj, params, lam)
        traj, lam = sol.traj, sol.lam
    sync()
    dt = (time.perf_counter() - t0) / n_rounds
    return {
        "batch": batch,
        "n_nodes": n_nodes,
        "round_time_s": dt,
        "instances_per_s": batch / dt,
        "sqp_iterations_per_s": batch * cfg.sqp_iterations / dt,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "devices": 1 if mesh is None else mesh.size,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                              else None),
        "finite": bool(torch.isfinite(sol.cost).all()),
    }


def scaling_report(batches=(1, 8, 64, 256), n_nodes: int = 28, *, device="cuda",
                   dtype=torch.float32) -> list[dict]:
    """`batched_throughput` at each batch size, in order."""
    return [batched_throughput(b, n_nodes, device=device, dtype=dtype) for b in batches]
