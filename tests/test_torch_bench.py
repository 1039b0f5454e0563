"""The port's bench entry, `wb_humanoid_mpc_tpu_torch/tools/bench.py`, on the
CPU in float64 at N = 4 (humanoid23).

- `main(argv)` prints exactly one JSON line with `bench.py`'s four keys, a
  finite value and vs_baseline = round(value / 60, 3), and returns it.
- Its final solve equals, exactly, as many warm-started calls of the port's
  `make_sqp_solver` on the same problem (1 warm-up + timed + latency
  samples), each taking the previous trajectory and multipliers.
- A non-finite cost (a NaN in x0) raises.
- `python -m wb_humanoid_mpc_tpu_torch.tools.bench` runs as a module.
The card's run (N = 28, K1 once per solve) is in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_common import NO_BATCHING_FALLBACK
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.tools import bench

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

REPO = Path(__file__).resolve().parent.parent
N, TIMED, SAMPLES = 4, 2, 2
ARGV = ["--device", "cpu", "--dtype", "float64", "--n-nodes", str(N), "--timed", str(TIMED),
        "--latency-samples", str(SAMPLES)]
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _check_line(out: dict) -> None:
    assert list(out) == KEYS
    assert "humanoid23" in out["metric"] and "PyTorch/CUDA port" in out["metric"]
    assert f"{N} nodes" in out["metric"] and "G1" not in out["metric"]
    assert out["unit"] == "iterations/s"
    assert math.isfinite(out["value"]) and out["value"] >= 0.0
    assert out["vs_baseline"] == round(out["value"] / 60.0, 3)


def test_bench_line_and_final_solve(monkeypatch, capsys):
    solutions = []

    def recording(*args, **kwargs):
        solve = make_sqp_solver(*args, **kwargs)

        def solve_and_keep(*a):
            solutions.append(solve(*a))
            return solutions[-1]

        return solve_and_keep

    monkeypatch.setattr(bench, "make_sqp_solver", recording)
    out = bench.main(ARGV)
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    _check_line(out)
    assert "per-call p50 latency" in captured.err

    pb = interface.build_wb_problem(interface.ASSETS / "humanoid23", N, device="cpu",
                                    dtype=torch.float64)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=1),
                            device="cpu")
    traj, lam = pb.traj, pb.lam
    for _ in range(1 + TIMED + SAMPLES):
        ref = solve(0.0, pb.x0, traj, pb.params, lam)
        traj, lam = ref.traj, ref.lam
    assert len(solutions) == 1 + TIMED + SAMPLES
    got = solutions[-1]
    for name, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us),
                       ("lam", got.lam, ref.lam), ("cost", got.cost, ref.cost)):
        assert torch.equal(a, b), name


def test_bench_raises_on_a_non_finite_cost(monkeypatch, capsys):
    build = bench.build_wb_problem

    def nan_x0(*args, **kwargs):
        pb = build(*args, **kwargs)
        x0 = pb.x0.clone()
        x0[0] = float("nan")
        return pb._replace(x0=x0)

    monkeypatch.setattr(bench, "build_wb_problem", nan_x0)
    with pytest.raises(RuntimeError, match="non-finite cost"):
        bench.main(["--device", "cpu", "--dtype", "float64", "--n-nodes", "3", "--timed", "1",
                    "--latency-samples", "1"])
    assert capsys.readouterr().out == ""


def test_bench_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "wb_humanoid_mpc_tpu_torch.tools.bench", *ARGV],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    _check_line(json.loads(lines[0]))
