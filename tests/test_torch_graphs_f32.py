"""PyTorch port, the compiled solve (`solver/graphs.py`) on the CPU in
float32: the cases of tests/test_torch_graphs.py (toy_biped, stance, N = 6,
projection + filter, the time-dependent OCP of tests/_graphs_cases.py)
through the graphed solve's static-buffer runner with capture off, against
the eager `make_sqp_solver` bit for bit, and against JAX's jitted solve run
in pure float32 (as on the TPU; compiled once in this file) at the
production tolerance 2e-3 max(1, max|ref|) (float32 noise accumulates
through the N-step Riccati chain, `__graft_entry__.py:120-126`), the same
step."""

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
from tests.test_torch_common import NO_BATCHING_FALLBACK, x64_off
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
TOL = 2e-3


@pytest.fixture(scope="module")
def jax_solve_f32():
    cfg, model, ocp = timed_jax_ocp("toy_biped")
    with x64_off():
        solve = jax.jit(jax_make_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                            JaxConfig(n_nodes=N, dt=cfg.sqp.dt,
                                                      sqp_iterations=1)))
        return solve, jax_problem(cfg, model, ocp, N, jnp.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_split_solve_equals_eager_bit_for_bit_f32(case):
    eager, split, _ = port_runs(case, N, "f32")
    assert_bitwise(split, eager, f"{case} f32")


@pytest.mark.parametrize("case", list(CASES))
def test_split_solve_matches_jax_f32(case, jax_solve_f32):
    _, split, calls = port_runs(case, N, "f32")
    iterations, batched, _ = CASES[case]
    assert_close_to_jax(split, calls, jax_solve_f32, TOL, f"{case} f32", iterations, batched,
                        jax_context=x64_off)
