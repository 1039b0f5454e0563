"""Profile warm-started whole-body SQP iterations on the card.

    python -m wb_humanoid_mpc_tpu_torch.tools.profile_sqp [--robot humanoid23]
        [--nodes 28] [--iters 3] [--out chiprun_out/profile_sqp.json]

Runs the `chip_smoke.py` main path (stance, f32), eagerly
(`make_sqp_solver(..., graphs=False)`), under `torch.profiler` and
reports, per SQP iteration: host wall time (of the same window run once
without and once with the profiler), kernel launches and device time in all
and per solver phase (the `sqp.*` ranges of `solver/sqp.py`), the device's
busy share of the wall time, and the kernels that take the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _phase_of(ev) -> str | None:
    while ev is not None:
        if ev.name.startswith("sqp."):
            return ev.name
        ev = ev.cpu_parent
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="humanoid23")
    ap.add_argument("--nodes", type=int, default=28)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_sqp.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sqp: no CUDA device", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    pb = build_wb_problem(ASSETS / args.robot, args.nodes, device="cuda", dtype=torch.float32)
    # the eager twin: the profiler sees each launch under its `sqp.*` range
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=args.nodes, dt=pb.cfg.sqp.dt), device="cuda",
                            graphs=False)
    traj = pb.traj
    for _ in range(3):
        traj = solve(0.0, pb.x0, traj, pb.params, pb.lam).traj
    torch.cuda.synchronize()
    # the same window without the profiler, whose own cost slows the host
    t0 = time.perf_counter()
    for _ in range(args.iters):
        traj = solve(0.0, pb.x0, traj, pb.params, pb.lam).traj
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            traj = solve(0.0, pb.x0, traj, pb.params, pb.lam).traj
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    phases: dict[str, dict] = {}
    for ev in events:
        if ev.name.startswith("sqp.") and ev.device_type.name == "CPU":
            ph = phases.setdefault(ev.name, {"host_ms": 0.0, "launches": 0, "device_ms": 0.0})
            ph["host_ms"] += ev.cpu_time_total / 1e3
    n_launch = 0
    for ev in events:
        if ev.name in _LAUNCH:
            n_launch += 1
            ph = _phase_of(ev)
            if ph is not None:
                phases[ph]["launches"] += 1
    # device side: the sqp.* ranges appear again on the device timeline, as
    # spans over their kernels; every other CUDA event is a kernel or a copy
    dev = [ev for ev in events if ev.device_type.name == "CUDA"]
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in dev
              if ev.name.startswith("sqp.")]
    kernels: dict[str, list] = {}
    spans = []
    for ev in dev:
        if ev.name.startswith("sqp."):
            continue
        t0k, t1k = ev.time_range.start, ev.time_range.end
        spans.append((t0k, t1k))
        kernels.setdefault(ev.name, [0, 0.0])
        kernels[ev.name][0] += 1
        kernels[ev.name][1] += t1k - t0k
        for r0, r1, name in ranges:
            if r0 <= t0k <= r1:
                phases[name]["device_ms"] += (t1k - t0k) / 1e3
                break
    # the device is busy where at least one kernel runs: the union of spans
    busy_us, end = 0.0, float("-inf")
    for t0k, t1k in sorted(spans):
        if t1k > end:
            busy_us += t1k - max(t0k, end)
            end = t1k
    n_kernels = len(spans)
    device_us = sum(t1k - t0k for t0k, t1k in spans)

    it = args.iters
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    report = {
        "card": card,
        "torch": torch.__version__,
        "robot": args.robot, "nodes": args.nodes, "iterations": it,
        "wall_ms_per_iter_unprofiled": wall_plain * 1e3 / it,
        "wall_ms_per_iter": wall * 1e3 / it,
        "launch_calls_per_iter": n_launch / it,
        "device_ops_per_iter": n_kernels / it,
        "device_ms_per_iter": device_us / 1e3 / it,
        "device_busy_ms_per_iter": busy_us / 1e3 / it,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_busy_share_of_unprofiled_wall": busy_us / 1e6 / wall_plain,
        "phases_per_iter": {k: {kk: vv / it for kk, vv in v.items()} for k, v in phases.items()},
        "top_kernels": [{"name": n[:120], "calls_per_iter": c / it, "device_ms_per_iter": t / 1e3 / it}
                        for n, (c, t) in top],
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    summary = {k: v for k, v in report.items() if k != "top_kernels"}
    print(json.dumps(summary, indent=1))
    for row in report["top_kernels"][:8]:
        print(f"  {row['device_ms_per_iter']:.4f} ms/iter  {row['calls_per_iter']:.0f} calls  "
              f"{row['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
