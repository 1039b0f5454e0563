"""PyTorch port, the compiled solve (`solver/graphs.py`) on the CPU, the AL +
merit path (equality_handling "al", line_search "merit": no host sync, one
graph an iteration, and the graph of the first g_prev once a call): the cases
of tests/test_torch_graphs.py (toy_biped, stance, N = 6, f64, the
time-dependent OCP of tests/_graphs_cases.py) through the static-buffer
runner with capture off, against the eager `make_sqp_solver` bit for bit and
against JAX's jitted one-iteration solve (compiled once in this file; k
iterations are k calls with the multipliers carried, which is what its
iterations compute: the first g_prev of a call is the last iteration's
max |g|) at 1e-6 max(1, max|ref|), the same step. The lower-ladder case
runs no ladder here: the merit search tries every step at once."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from tests._graphs_cases import (
    CASES,
    assert_bitwise,
    assert_close_to_jax,
    jax_problem,
    port_runs,
    timed_jax_ocp,
)
from tests.test_torch_common import NO_BATCHING_FALLBACK
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
TOL = 1e-6
AL_MERIT = (("equality_handling", "al"), ("line_search", "merit"))


@pytest.fixture(scope="module")
def jax_solve_al():
    cfg, model, ocp = timed_jax_ocp("toy_biped")
    solve = jax.jit(jax_make_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                        JaxConfig(n_nodes=N, dt=cfg.sqp.dt, sqp_iterations=1,
                                                  **dict(AL_MERIT))))
    return solve, jax_problem(cfg, model, ocp, N, jnp.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_al_split_solve_equals_eager_bit_for_bit(case):
    eager, split, _ = port_runs(case, N, "f64", AL_MERIT)
    assert_bitwise(split, eager, f"{case} al+merit")


@pytest.mark.parametrize("case", list(CASES))
def test_al_split_solve_matches_jax(case, jax_solve_al):
    _, split, calls = port_runs(case, N, "f64", AL_MERIT)
    iterations, batched, _ = CASES[case]
    assert_close_to_jax(split, calls, jax_solve_al, TOL, f"{case} al+merit", iterations,
                        batched)
