"""PyTorch port, the slice as a whole: `make_sqp_solver` (projection + filter
path) on `toy_biped`, N = 6, against JAX's `make_sqp_solver` on the CPU
(XLA/scan paths), for 1 and 2 SQP iterations, in two setups: stance (the
`bench.py` problem) and the walking schedule of `__graft_entry__.py` scaled
to N. JAX's 2-iteration result is its 1-iteration solve applied twice, which
is what its `lax.scan` over iterations computes on the projection path.

Tolerances: f64 max|Δ| <= 1e-6 max(1, max|ref|); f32 <= 2e-3 max(1, max|ref|)
(float32 noise accumulates through the N-step Riccati chain,
`__graft_entry__.py:120-126`); step_size equal in both."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    ASSETS,
    DTYPES,
    NO_BATCHING_FALLBACK,
    jax_mode,
    jax_wb,
    to_numpy,
)
from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
from wb_humanoid_mpc_tpu.refs.swing import SwingReference
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu_torch.interface import (
    build_wb_problem,
    stance_reference,
    walking_reference,
)
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
SETUPS = {"stance": stance_reference, "walk": walking_reference}
TOL = {"f64": 1e-6, "f32": 2e-3}


@pytest.fixture(scope="module")
def jax_solutions():
    """{(setup, dtype): [(xs, us, cost, g_norm, step_size, x_ref, u_ref) after
    iteration 1, ... after iteration 2]} from the JAX solver, as numpy."""
    cfg, model, ocp = jax_wb("toy_biped")
    out = {}
    for dtype in ("f64", "f32"):
        jdt = DTYPES[dtype][0]
        with jax_mode(dtype):
            solve = jax.jit(jax_make_sqp_solver(
                ocp, model.flow_map, ocp.barrier_params(),
                JaxConfig(n_nodes=N, dt=cfg.sqp.dt, sqp_iterations=1)))
            for setup, reference in SETUPS.items():
                ref = reference(N)
                swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos,
                                       z_vel=ref.z_vel, z_acc=ref.z_acc,
                                       proximity=ref.proximity)
                x0 = jnp.asarray(cfg.initial_state, dtype=jdt)
                params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
                u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity,
                                       jnp.ones(2), model.layout.input_dim)
                traj = JaxTrajectory(xs=jnp.tile(x0, (N + 1, 1)), us=jnp.tile(u0, (N, 1)))
                lam = jnp.zeros((N, ocp.n_eq), jdt)
                sols = []
                for _ in range(2):
                    sol = solve(0.0, x0, traj, params, lam)
                    traj = sol.traj
                    sols.append(to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm,
                                          sol.step_size, params.x_ref, params.u_ref)))
                out[(setup, dtype)] = sols
    return out


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("setup", list(SETUPS))
def test_sqp_matches_jax(jax_solutions, setup, dtype, iterations):
    ref = jax_solutions[(setup, dtype)][iterations - 1]
    tdt = DTYPES[dtype][1]
    pb = build_wb_problem(ASSETS / "toy_biped", N, device="cpu", dtype=tdt,
                          swing=SETUPS[setup](N))
    # both packages solve the same problem
    np.testing.assert_allclose(pb.params.x_ref.numpy(), ref[5], rtol=0, atol=0)
    np.testing.assert_allclose(pb.params.u_ref.numpy(), ref[6], rtol=1e-15, atol=0)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt,
                                            sqp_iterations=iterations),
                            device="cpu")
    sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    got = to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm))
    for name, a, b in zip(("traj.xs", "traj.us", "cost", "g_norm"), got, ref[:4]):
        b = np.asarray(b, np.float64)
        limit = TOL[dtype] * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        assert err <= limit, f"{setup} {dtype} it{iterations} {name}: {err:.3e} > {limit:.3e}"
    assert float(sol.step_size) == float(ref[4])
    assert np.isfinite(got[2]) and sol.iterations == iterations
