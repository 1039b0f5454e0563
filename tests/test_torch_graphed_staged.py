"""PyTorch port, the graphed staged solver (`make_staged_sqp_solver`, one CUDA
graph a phase: `solver/graphs.py::GraphedStagedSolve`) on the CPU, at
humanoid23's width (nx 58, nu 35, 14 equality rows), N = 4, two SQP
iterations a call, float64 and float32. The OCP is the whole-body one with
every residual shifted by TIME_GAIN sin(t) (tests/_graphs_cases.py), so that
a t0 baked into a graph would show. A CPU has no CUDA graphs, so the phases
run through the graph runner with capture off
(`GraphedStagedSolve(..., capture=False)`), against

- the eager staged solver (`graphs=False`), bit for bit: xs, us,
  multipliers, cost, g_norm, defect norm and step of every call, and the
  same four phase fields;
- the JAX package's `make_staged_sqp_solver` (its phases jitted; the plain
  XLA paths for its kernels, as the JAX tests run it on the CPU) on the same
  calls: float64 at 1e-10 max(1, max|ref|), float32 (JAX in pure float32)
  at 2e-3 max(1, max|ref|) (tests/test_torch_sqp.py's float32 tolerance),
  the same step.

The calls: t0 = 0 from the stance start, t0 = 0.35 warm-started from the
first call's solution, t0 = 0.7 from the stance start again."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._graphs_cases import TimedPortOcp, jax_problem, timed_jax_ocp
from tests.test_torch_common import DTYPES, NO_BATCHING_FALLBACK, jax_mode, to_numpy
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_staged_sqp_solver as jax_make_staged_sqp_solver
from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedStagedSolve
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    PhaseTimings,
    SqpSolverConfig,
    StagedIteration,
    make_staged_sqp_solver,
)
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 4
ITERATIONS = 2
TOL = {"f64": 1e-10, "f32": 2e-3}
CALLS = ((0.0, False), (0.35, True), (0.7, False))   # (t0, warm start from the last call)
FIELDS = ("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size")


def _fields(sol):
    return (sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.defect_norm,
            sol.step_size)


@functools.lru_cache(maxsize=None)
def _port_runs(dtype: str):
    """{eager, runner: [(solution, PhaseTimings)] one a call}."""
    pb = build_wb_problem(ASSETS / "humanoid23", N, device="cpu", dtype=DTYPES[dtype][1])
    ocp = TimedPortOcp(model=pb.model, cfg=pb.cfg)
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=ITERATIONS)
    solvers = {
        "eager": make_staged_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device="cpu",
                                        graphs=False),
        "runner": GraphedStagedSolve(StagedIteration(ocp, pb.model.flow_map, pb.bp, cfg),
                                     torch.device("cpu"), capture=False),
    }
    out = {}
    for name, solve in solvers.items():
        runs, prev = [], None
        for t0, warm in CALLS:
            traj = prev.traj if warm else Trajectory(xs=pb.traj.xs, us=pb.traj.us)
            prev, phases = solve(t0, pb.x0, traj, pb.params, pb.lam)
            runs.append((prev, phases))
        out[name] = runs
    return out


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_runner_equals_eager_bit_for_bit(dtype):
    runs = _port_runs(dtype)
    for k, ((got, got_t), (ref, ref_t)) in enumerate(zip(runs["runner"], runs["eager"])):
        for name, a, b in zip(FIELDS, _fields(got), _fields(ref)):
            assert a.dtype == b.dtype and torch.equal(a, b), (
                f"{dtype} call {k} {name}: runner and eager differ by "
                f"{float((a - b).abs().max()):.3e}")
        assert got.iterations == ref.iterations == ITERATIONS
        assert isinstance(got_t, PhaseTimings) and got_t._fields == ref_t._fields
        assert min(got_t) >= 0.0 and sum(got_t) > 0.0
    # the time-dependent OCP: the same start at another t0 gives another answer
    first, third = runs["runner"][0][0], runs["runner"][2][0]
    assert float((first.traj.us - third.traj.us).abs().max()) > 1e-6


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_runner_matches_jax(dtype):
    runs = _port_runs(dtype)
    jdt = DTYPES[dtype][0]
    cfg, model, ocp = timed_jax_ocp("humanoid23")
    with jax_mode(dtype):
        solve = jax_make_staged_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                           JaxConfig(n_nodes=N, dt=cfg.sqp.dt,
                                                     sqp_iterations=ITERATIONS))
        x0, traj0, params, lam = jax_problem(cfg, model, ocp, N, jdt)
        prev = None
        for k, ((t0, warm), (got, _)) in enumerate(zip(CALLS, runs["runner"])):
            prev, _ = solve(jnp.asarray(t0, jdt), x0, prev.traj if warm else traj0, params,
                            lam)
            ref = to_numpy((prev.traj.xs, prev.traj.us, prev.cost, prev.g_norm))
            mine = to_numpy((got.traj.xs, got.traj.us, got.cost, got.g_norm))
            for name, a, b in zip(("xs", "us", "cost", "g_norm"), mine, ref):
                b = np.asarray(b, np.float64)
                limit = TOL[dtype] * max(1.0, float(np.abs(b).max()))
                err = float(np.abs(np.asarray(a, np.float64) - b).max())
                assert err <= limit, (f"{dtype} call {k} {name}: max|port - JAX| {err:.3e} > "
                                      f"{limit:.3e}")
            assert float(got.step_size) == float(prev.step_size), f"{dtype} call {k}"
