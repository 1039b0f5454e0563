"""PyTorch port, the first call of every graphed program (`utils/graphs.py`:
the SQP solve, the staged solver's phases, the MRT controllers' feed-forward,
the dummy plant's RK4 step) on the CPU, with the capture emulated.

The first call of a graphed program runs its pieces once eagerly (the
warm-up), captures them, then replays what the call still needs: with one
SQP iteration a call, nothing. A capture records the pieces' operations
without running them, so any tensor a piece creates while capturing holds
no value until a replay; whatever the host reads after the first call must
have come from the warm-up, through a static buffer. A CPU has no CUDA
graphs, so `PieceGraphs`' warm-up runs the pieces eagerly here and its
capture runs each piece under `Capturing` (tests/_graphs_common.py), a
dispatch mode that gives every result a meaningless value (NaN, or 0 for
integers and booleans), leaves every written tensor as it was and refuses
host reads, as a capture does; a replay runs the piece eagerly. The
runners of `capture=False` are switched to capture so, on the same buffers;
each program's first and second calls are held against its eager twin
(`graphs=False`) bit for bit, at humanoid23's width, float64: one and two
iterations a call for the solve and the staged solver, both formulations
for the controllers and the plant step. The sharded solve's first call is
tests/test_torch_graphed_sharded.py's."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests._graphs_common import Capturing, TimedPortOcp, capture_all, warm_up
from tests.test_torch_common import NO_BATCHING_FALLBACK, port_centroidal, port_wb
from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem
from wb_humanoid_mpc_tpu_torch.mpc import controller
from wb_humanoid_mpc_tpu_torch.mpc.runtime import Policy
from wb_humanoid_mpc_tpu_torch.sim import dummy
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve, GraphedStagedSolve
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    SqpIteration,
    SqpSolverConfig,
    StagedIteration,
    make_sqp_solver,
    make_staged_sqp_solver,
)
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils import graphs
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 4
CPU = torch.device("cpu")
SOLUTION = ("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size")


@pytest.fixture
def emulated_capture(monkeypatch):
    monkeypatch.setattr(graphs.PieceGraphs, "_warm_up", warm_up)
    monkeypatch.setattr(graphs.PieceGraphs, "_capture_all", capture_all)


def _capturing(runner):
    """A `capture=False` runner switched to capture (emulated)."""
    runner.capture = True
    return runner


def _assert_same(got, ref, what):
    for name, a, b in zip(SOLUTION if isinstance(got, tuple) else ("value",),
                          got if isinstance(got, tuple) else (got,),
                          ref if isinstance(ref, tuple) else (ref,)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.dtype == b.dtype and torch.equal(a, b), (
            f"{what} {name}: the graphed program and its eager twin differ "
            f"({float((a - b).abs().nan_to_num(float('inf')).max()):.3e})")


def _fields(sol):
    return (sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.defect_norm,
            sol.step_size)


@functools.lru_cache(maxsize=None)
def _problem():
    pb = build_wb_problem(ASSETS / "humanoid23", N, device="cpu", dtype=torch.float64)
    return pb, TimedPortOcp(model=pb.model, cfg=pb.cfg)


def test_emulated_capture_leaves_no_value():
    """The emulation itself: what a piece computes while capturing holds no
    value, and a tensor it writes keeps its own."""
    buf = torch.ones(3, dtype=torch.float64)
    with Capturing():
        y = torch.sin(buf) + 1.0
        buf.copy_(y)
        with pytest.raises(RuntimeError, match="host read"):
            float(y.sum())
    assert torch.isnan(y).all() and torch.equal(buf, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("solver", ["sqp", "staged"])
def test_first_call_equals_eager(emulated_capture, solver, iterations):
    pb, ocp = _problem()
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=iterations)
    if solver == "sqp":
        eager = make_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device="cpu", graphs=False)
        graphed = GraphedSqpSolve(SqpIteration(ocp, pb.model.flow_map, pb.bp, cfg), CPU,
                                  capture=False)
    else:
        eager = make_staged_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device="cpu",
                                       graphs=False)
        graphed = GraphedStagedSolve(StagedIteration(ocp, pb.model.flow_map, pb.bp, cfg), CPU,
                                     capture=False)
    graphed = _capturing(graphed)
    traj = Trajectory(xs=pb.traj.xs, us=pb.traj.us)
    for k, t0 in enumerate((0.0, 0.35)):
        got, ref = (solve(t0, pb.x0, traj, pb.params, pb.lam) for solve in (graphed, eager))
        if solver == "staged":
            got, ref = got[0], ref[0]
        _assert_same(_fields(got), _fields(ref), f"{solver} call {k}")
        assert got.iterations == ref.iterations == iterations
        traj = got.traj
    (s,) = graphed.sets.values()
    assert set(s.graphs) == {p.name for p in s.pieces}


CONTROLLERS = {"wb": (port_wb, controller.WBMrtController),
               "centroidal": (port_centroidal, controller.CentroidalMrtController)}


@pytest.mark.parametrize("form", list(CONTROLLERS))
def test_first_controller_tick_equals_eager(emulated_capture, form):
    setup, cls = CONTROLLERS[form]
    cfg, model, _ = setup("humanoid23")
    eager = cls(model, device="cpu", dtype=torch.float64, graphs=False)
    graphed = cls(model, device="cpu", dtype=torch.float64, graphs=False)
    graphed.graph = _capturing(GraphedFunction(graphed.feed_forward, CPU, "feed-forward",
                                               capture=False))
    x0 = np.asarray(cfg.initial_state, dtype=np.float64)
    rng = np.random.default_rng(5)
    xs = x0 + 0.02 * rng.standard_normal((3, x0.size))
    us = np.tile(eager._u_comp, (2, 1)) + 0.5 * rng.standard_normal((2, eager._u_comp.size))
    pol = Policy(t0=0.0, dt=0.04, xs=xs, us=us, contact_flags=np.ones((3, 2)))
    for k, (t, policy) in enumerate(((0.0, None), (0.013, pol), (0.05, pol))):
        got, ref = (c.compute(t, x0, policy).ff_effort for c in (graphed, eager))
        _assert_same(got, ref, f"{form} tick {k}")
    assert len(graphed.graph.entries) == 1


@pytest.mark.parametrize("form", list(CONTROLLERS))
def test_first_plant_step_equals_eager(emulated_capture, form):
    cfg, model, _ = CONTROLLERS[form][0]("humanoid23")
    flow = lambda t, x, u: model.flow_map(t, x, u) + 0.05 * torch.sin(t)  # noqa: E731
    eager = dummy.PlantStep(flow, 0.02, CPU, torch.float64, graphs=False)
    graphed = dummy.PlantStep(flow, 0.02, CPU, torch.float64, graphs=False)
    graphed.graph = _capturing(GraphedFunction(graphed.step, CPU, "RK4 step", capture=False))
    rng = np.random.default_rng(6)
    x0 = np.asarray(cfg.initial_state, dtype=np.float64)
    for k, t in enumerate((0.0, 0.3)):
        x = x0 + 0.02 * rng.standard_normal(x0.size)
        u = 5.0 * rng.standard_normal(model.layout.input_dim)
        _assert_same(graphed(t, x, u), eager(t, x, u), f"{form} step {k}")
