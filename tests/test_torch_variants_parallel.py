"""PyTorch port, the SQP solver with the associative-scan Riccati pair
(`parallel_riccati=True`, `solver/priccati.py`) on the projection path and
on the AL path, against JAX's `make_sqp_solver` on `toy_biped`, N = 6,
stance and walk, two SQP iterations; the projection path in f64 and in f32
(JAX in pure float32, as on the TPU), the AL path in f64. The scan trees differ (see
tests/test_torch_priccati.py), so the two agree to roundoff.

Tolerances: f64 1e-6 and f32 2e-3 x max(1, max|ref|), the same step
(tests/test_torch_sqp.py). See tests/test_torch_variants.py for the rest."""

from __future__ import annotations

import pytest

from tests.test_torch_common import NO_BATCHING_FALLBACK, check_variant, jax_solutions
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
FIELDS = dict(parallel_riccati=True, sqp_iterations=2)
AL_FIELDS = dict(FIELDS, equality_handling="al")


@pytest.fixture(scope="module")
def jax_refs():
    return jax_solutions(jax_make_sqp_solver, FIELDS, N, dtypes=("f64", "f32"))


@pytest.fixture(scope="module")
def jax_al_refs():
    return jax_solutions(jax_make_sqp_solver, AL_FIELDS, N)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("setup", ["stance", "walk"])
def test_parallel_riccati_matches_jax(jax_refs, setup, dtype):
    check_variant(jax_refs, FIELDS, setup, dtype, N)


@pytest.mark.parametrize("setup", ["stance", "walk"])
def test_parallel_riccati_al_path_matches_jax(jax_al_refs, setup):
    check_variant(jax_al_refs, AL_FIELDS, setup, "f64", N)
