"""Batch-scaling benchmark harness.

    python -m wb_humanoid_mpc_tpu_torch.parallel.scaling [--batches 1 8 64 256 1024]

PyTorch counterpart of `batched_throughput` and `scaling_report` in
`wb_humanoid_mpc_tpu/parallel/scaling.py`: batched SQP iterations/s at
increasing batch sizes, on one device or across the `dp` axis of a rank
mesh (`shard_batched_solver`); on the card each batch size's solve runs
as CUDA graphs, captured at its first call. The problem is `bench.py`'s stance
problem built by `interface.build_wb_problem` on `assets/humanoid23`; each
instance starts from its own perturbed x0. `scaling_report` records a
batch that fails (a device out of memory, for one) and stops there, as
JAX's does.
"""

from __future__ import annotations

import argparse
import json
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


def batched_throughput(batch: int, n_nodes: int = 28, formulation: str = "wb",
                       n_rounds: int = 30, seed: int = 0,
                       solver_overrides: dict | None = None, *, device="cuda",
                       dtype=torch.float32, mesh=None) -> dict:
    """Instances/s and SQP iterations/s of one batched solve of `batch`
    instances, one SQP iteration each unless `solver_overrides` (fields of
    `SqpSolverConfig`) say otherwise: a first solve, then `n_rounds`
    warm-started rounds queued back to back with one synchronization at the
    end (the MRT pipelining mode). The problem is the whole-body stance
    problem whatever `formulation` says, as in JAX's harness. With a rank
    `mesh`, every rank of it calls this: the batch is split over its `dp`
    axis (`shard_batched_solver`) and `devices` counts its ranks, as JAX's
    `len(jax.devices())`. `sqp_iterations_per_s` is B x iterations a solve
    / round time, where JAX reports B / round time: the two differ only when
    an override sets more than one iteration."""
    pb = build_wb_problem(ASSETS / "humanoid23", n_nodes, device=device, dtype=dtype)
    dev = pb.x0.device
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt,
                          **{"sqp_iterations": 1, **(solver_overrides or {})})
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


def scaling_report(batches=(1, 8, 64, 256, 1024), n_nodes: int = 28,
                   solver_overrides: dict | None = None, *, device="cuda",
                   dtype=torch.float32) -> list[dict]:
    """`batched_throughput` at each batch size, in order. A point that fails
    (`torch.cuda.OutOfMemoryError` or any other error) is recorded as
    {"batch", "n_nodes", "error"} (the error's first line, at most 200
    characters) and ends the sweep; the CUDA cache is freed after each
    point."""
    out = []
    for b in batches:
        try:
            out.append(batched_throughput(b, n_nodes, solver_overrides=solver_overrides,
                                          device=device, dtype=dtype))
        except Exception as e:  # noqa: BLE001 -- record OOM and other failures
            out.append({"batch": b, "n_nodes": n_nodes,
                        "error": (str(e).splitlines() or [type(e).__name__])[0][:200]})
            break
        finally:
            # the point's solver, its graphs and their pool are gone: hand
            # their memory back before the next batch size
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="wb_humanoid_mpc_tpu_torch.parallel.scaling",
                                 description="scaling_report on the card, one JSON line")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 64, 256, 1024])
    ap.add_argument("--n-nodes", type=int, default=28)
    args = ap.parse_args()
    print(json.dumps(scaling_report(tuple(args.batches), args.n_nodes)))
