"""Benchmark of the port: humanoid23 whole-body MPC SQP iterations/s.

    python -m wb_humanoid_mpc_tpu_torch.tools.bench

The port's counterpart of the repo's `bench.py`, which stays the JAX
package's (it loads the G1 from the reference tree). The problem is the
same stance problem, built by the port's `interface.build_wb_problem` on
`assets/humanoid23` (the G1's widths: nx 58, nu 35, 14 equality rows):
N = 28 nodes of the task's 0.035 s, one SQP iteration a solve, each solve
warm-started from the previous one's trajectory and multipliers. On the card
the solve runs as `make_sqp_solver` gives it by default, as CUDA graphs
(`solver/graphs.py`, the counterpart of `bench.py`'s `jax.jit`): the
warm-up solve captures them, every later solve replays them. Each
iteration launches K1 (`csrc/riccati.cu`) once and K2 (`csrc/fkvel.cu`) six
to nine times, through the solver's normal backends.

Timing as `bench.py`: one synced warm-up solve; `--timed` solves back to
back with one synchronization at the end (sustained iterations/s, the
value); then `--latency-samples` solves, each synced (per-call p50, on
stderr). Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"},
vs_baseline = value / 60 (the reference's 60 Hz whole-body MPC), and raises
on a non-finite cost. Runs on the card; `--device cpu` (with `--dtype
float64`, a small `--n-nodes`) is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

BASELINE_IT_PER_S = 60.0   # bench.py: the reference's whole-body SQP at 60 Hz
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="wb_humanoid_mpc_tpu_torch.tools.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu (the tests)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--n-nodes", type=int, default=28)
    p.add_argument("--timed", type=int, default=50,
                   help="solves back to back with one sync at the end")
    p.add_argument("--latency-samples", type=int, default=10,
                   help="solves, each synced, for the per-call p50")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    N = args.n_nodes
    pb = build_wb_problem(ASSETS / "humanoid23", N, device=dev, dtype=DTYPES[args.dtype])
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)   # warm-up
    sync()
    traj, lam = sol.traj, sol.lam

    # sustained warm-started receding-horizon throughput: solves dispatched
    # back to back, each consuming the previous solution, one sync at the end
    t0 = time.perf_counter()
    for _ in range(args.timed):
        sol = solve(0.0, pb.x0, traj, pb.params, lam)
        traj, lam = sol.traj, sol.lam
    sync()
    sustained = args.timed / (time.perf_counter() - t0)

    lat = []
    for _ in range(args.latency_samples):
        t1 = time.perf_counter()
        sol = solve(0.0, pb.x0, traj, pb.params, lam)
        sync()
        lat.append(time.perf_counter() - t1)
        traj, lam = sol.traj, sol.lam
    p50 = float(np.percentile(lat, 50))
    sys.stderr.write(f"per-call p50 latency: {p50 * 1e3:.2f} ms "
                     f"({1.0 / p50:.1f}/s); sustained: {sustained:.1f}/s\n")

    if not np.isfinite(float(sol.cost)):
        raise RuntimeError("benchmark solve produced non-finite cost")

    value = round(sustained, 2)
    out = {
        "metric": (f"humanoid23 whole-body MPC SQP iterations/s, PyTorch/CUDA port "
                   f"({N * cfg.dt:.2f} s horizon, {N} nodes, warm-started)"),
        "value": value,
        "unit": "iterations/s",
        "vs_baseline": round(value / BASELINE_IT_PER_S, 3),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
