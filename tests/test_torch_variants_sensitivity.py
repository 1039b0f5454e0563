"""PyTorch port, the SQP solver with the "exact" (differentiate the whole RK4
step and the node terms over z = (x, u)) and "midpoint" (A, B relinearized
at the RK4 midpoint) sensitivities of `make_node_lq`, against JAX's
`make_sqp_solver` on `toy_biped`, N = 6, stance and walk, two SQP
iterations, f64; and each mode's node LQ (all 15 outputs) against JAX's
`make_node_lq` in f64 and f32.

Tolerances: whole solves f64 1e-6 x max(1, max|ref|), the same step
(tests/test_torch_sqp.py); the node LQ as tests/test_torch_ocp.py (f64 rtol
1e-9, f32 1e-3 x max(1, max|ref|)). See tests/test_torch_variants.py for the
rest."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from tests.test_torch_common import (
    DTYPES,
    NO_BATCHING_FALLBACK,
    check_variant,
    jax_mode,
    jax_solutions,
    jax_wb,
    port_wb,
    to_numpy,
)
from tests.test_torch_ocp import _jax_args, _node_inputs, _port_args, _scaled_close
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver
from wb_humanoid_mpc_tpu.solver.transcription import make_node_lq as jax_make_node_lq
from wb_humanoid_mpc_tpu_torch.solver.transcription import make_node_lq

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
VARIANTS = {"exact": dict(sensitivity="exact", sqp_iterations=2),
            "midpoint": dict(sensitivity="midpoint", sqp_iterations=2)}


@pytest.fixture(scope="module")
def jax_refs():
    return {name: jax_solutions(jax_make_sqp_solver, fields, N)
            for name, fields in VARIANTS.items()}


@pytest.mark.parametrize("setup", ["stance", "walk"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sensitivity_matches_jax(jax_refs, variant, setup):
    check_variant(jax_refs[variant], VARIANTS[variant], setup, "f64", N)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("sensitivity", ["exact", "midpoint"])
def test_make_node_lq_matches_jax(sensitivity, dtype):
    """All 15 outputs, x_next being the full RK4 step in both modes."""
    x, u, params, lam = _node_inputs(4)
    jcfg, jmodel, jocp = jax_wb("toy_biped")
    _, _, tocp = port_wb("toy_biped")
    dt, rho = jcfg.sqp.dt, 10.0
    with jax_mode(dtype):
        node_lq = jax_make_node_lq(jocp, jmodel.flow_map, dt, jocp.barrier_params(),
                                   sensitivity=sensitivity)
        ref = to_numpy(jax.jit(jax.vmap(node_lq, in_axes=(0, 0, 0, 0, 0, None)))(
            *_jax_args(x, u, params, lam, dtype), rho))
    port_lq = make_node_lq(tocp, tocp.model.flow_map, dt,
                           tocp.barrier_params("cpu", DTYPES[dtype][1]), sensitivity=sensitivity)
    got = to_numpy(port_lq(*_port_args(x, u, params, lam, dtype), rho))
    assert len(got) == len(ref) == 15
    assert np.isfinite(got[0]).all()
    _scaled_close(got, ref, {"f64": 1e-9, "f32": 1e-3}[dtype], f"make_node_lq {sensitivity}")
