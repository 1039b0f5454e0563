"""PyTorch port, the SQP solver's AL equality path with the merit line
search (all eight steps at once, the largest that decreases the merit; the
safeguarded, clamped multiplier update) against JAX's `make_sqp_solver` on
`toy_biped`, N = 6, stance and walk, two SQP iterations, in f64 and in f32
(JAX in pure float32, as on the TPU).

Tolerances: f64 1e-6 and f32 2e-3 x max(1, max|ref|), the same step
(tests/test_torch_sqp.py). See tests/test_torch_variants.py for the rest."""

from __future__ import annotations

import pytest

from tests.test_torch_common import NO_BATCHING_FALLBACK, check_variant, jax_solutions
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
FIELDS = dict(equality_handling="al", line_search="merit", sqp_iterations=2)


@pytest.fixture(scope="module")
def jax_refs():
    return jax_solutions(jax_make_sqp_solver, FIELDS, N, dtypes=("f64", "f32"))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("setup", ["stance", "walk"])
def test_al_merit_matches_jax(jax_refs, setup, dtype):
    check_variant(jax_refs, FIELDS, setup, dtype, N)
