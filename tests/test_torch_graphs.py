"""PyTorch port, the compiled solve (`solver/graphs.py`) on the CPU: the split
SQP iteration through the graphed solve's static-buffer runner with capture
off (a CPU has no CUDA graphs), on toy_biped (stance, N = 6, f64, the
projection + filter path), against

- the eager `make_sqp_solver`, bit for bit: xs, us, multipliers and the four
  stats of every call;
- JAX's `jax.jit(make_sqp_solver(...))` (one iteration a call, compiled once
  in this file) at 1e-6 max(1, max|ref|), the same step
  (tests/test_torch_sqp.py's f64 tolerance).

The OCP is the whole-body one with every residual shifted by
TIME_GAIN sin(t) (tests/_graphs_cases.py), so that a solve at a time other
than its call's t0 shows. Cases (`CASES`): 2 and 12 SQP iterations, a start
that accepts neither top step (the lower ladder runs), a batch of 3
(instance 2 down the lower ladder), t0 changed between consecutive calls,
params changed between calls, a warm start from the previous output; and a
held solution that the next call leaves unchanged.
tests/test_torch_graphs_f32.py and tests/test_torch_graphs_al.py hold the
float32 and the AL + merit paths, tests/test_torch_sqp_humanoid23.py the
humanoid23 iteration at N = 28."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._graphs_cases import (
    CASES,
    assert_bitwise,
    assert_close_to_jax,
    jax_problem,
    port_runs,
    solvers,
    timed_jax_ocp,
)
from tests.test_torch_common import NO_BATCHING_FALLBACK
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
TOL = 1e-6


@pytest.fixture(scope="module")
def jax_solve():
    """JAX's jitted one-iteration solve of the time-dependent toy_biped OCP
    (f64) and its problem inputs."""
    cfg, model, ocp = timed_jax_ocp("toy_biped")
    solve = jax.jit(jax_make_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                        JaxConfig(n_nodes=N, dt=cfg.sqp.dt, sqp_iterations=1)))
    return solve, jax_problem(cfg, model, ocp, N, jnp.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_split_solve_equals_eager_bit_for_bit(case):
    eager, split, _ = port_runs(case, N, "f64")
    assert_bitwise(split, eager, case)


@pytest.mark.parametrize("case", list(CASES))
def test_split_solve_matches_jax(case, jax_solve):
    _, split, calls = port_runs(case, N, "f64")
    iterations, batched, _ = CASES[case]
    assert_close_to_jax(split, calls, jax_solve, TOL, case, iterations, batched)


def test_the_cases_exercise_what_they_name():
    """The lower-ladder start takes a step below the top two; the batch
    sends instance 2 down the ladder and the others not; a changed t0 and
    changed params change the solution."""
    _, split, _ = port_runs("lower_ladder", N, "f64")
    assert 0.0 < float(split[0].step_size) < 0.7
    _, split, _ = port_runs("batch_3", N, "f64")
    steps = split[0].step_size.tolist()
    assert steps[0] in (1.0, 0.7) and steps[1] in (1.0, 0.7) and 0.0 < steps[2] < 0.7, steps
    for case in ("t0_changes", "params_change"):
        _, split, _ = port_runs(case, N, "f64")
        assert float((split[0].traj.us - split[1].traj.us).abs().max()) > 1e-6, case


def test_held_solution_is_unchanged_by_the_next_call():
    """A solution the caller holds is a copy: the next call, at another t0,
    writes the runner's buffers and leaves it as it was."""
    pb, _, solve = solvers(N, "f64", 1, {})
    first = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    fields = (first.traj.xs, first.traj.us, first.lam, first.cost, first.step_size)
    held = [t.clone() for t in fields]
    second = solve(0.5, pb.x0, first.traj, pb.params, first.lam)
    assert all(torch.equal(a, b) for a, b in zip(fields, held))
    (gs,) = solve.sets.values()
    assert first.traj.xs.data_ptr() != gs.traj.xs.data_ptr()
    assert not torch.equal(first.traj.us, second.traj.us)
    assert np.isfinite(float(second.cost))


def test_recovery_solve_replays_the_same_graph_set():
    """The runtime's recovery solve, `with_iterations(12)` of its solve,
    runs on the solve's own graph set: bit for bit the eager 12-iteration
    solve, with the set of the solve's first call and no other; releasing
    the solve releases it for both."""
    pb, _, solve = solvers(N, "f64", 1, {})
    _, eager_12, _ = solvers(N, "f64", 12, {})
    recovery = solve.with_iterations(12)
    first = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    (gs,) = solve.sets.values()
    got = recovery(0.3, pb.x0, first.traj, pb.params, first.lam)
    ref = eager_12(0.3, pb.x0, first.traj, pb.params, first.lam)
    assert_bitwise([got], [ref], "recovery")
    assert (first.iterations, got.iterations) == (1, 12)
    assert recovery.sets is solve.sets and list(solve.sets.values()) == [gs]
    solve.release()
    assert not recovery.sets
