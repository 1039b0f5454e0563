"""PyTorch port, the main path's own shape against JAX: one warm-started SQP
iteration (projection + filter) of `humanoid23` (nx 58, nu 35, 14 equality
rows) at N = 28, the stance setup of `bench.py`, in float64 on the CPU, the
port's `make_sqp_solver` against JAX's (XLA/scan paths). tests/test_torch_sqp.py
holds the same solver on `toy_biped` at N = 6; this file is the check at
the widths and horizon the card runs, in a file of its own so that
`--dist loadfile` gives its JAX compile a worker of its own.

Tolerance as tests/test_torch_sqp.py in f64: max|Δ| <= 1e-6 max(1, max|ref|)
on xs, us, cost and g_norm; step_size equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, NO_BATCHING_FALLBACK, jax_wb, to_numpy
from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
from wb_humanoid_mpc_tpu.refs.swing import SwingReference
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu_torch.interface import build_wb_problem, stance_reference
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 28
TOL = 1e-6


@pytest.fixture(scope="module")
def jax_solution():
    """(xs, us, cost, g_norm, step_size, x_ref, u_ref) after one JAX SQP
    iteration of the humanoid23 stance problem, f64, as numpy."""
    cfg, model, ocp = jax_wb("humanoid23")
    solve = jax.jit(jax_make_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                        JaxConfig(n_nodes=N, dt=cfg.sqp.dt, sqp_iterations=1)))
    ref = stance_reference(N)
    swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos, z_vel=ref.z_vel,
                           z_acc=ref.z_acc, proximity=ref.proximity)
    x0 = jnp.asarray(cfg.initial_state, dtype=jnp.float64)
    params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
    u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity, jnp.ones(2),
                           model.layout.input_dim)
    traj = JaxTrajectory(xs=jnp.tile(x0, (N + 1, 1)), us=jnp.tile(u0, (N, 1)))
    sol = solve(0.0, x0, traj, params, jnp.zeros((N, ocp.n_eq), jnp.float64))
    return to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm, sol.step_size,
                     params.x_ref, params.u_ref))


def test_humanoid23_iteration_matches_jax(jax_solution):
    ref = jax_solution
    pb = build_wb_problem(ASSETS / "humanoid23", N, device="cpu", dtype=torch.float64,
                          swing=stance_reference(N))
    assert (pb.model.state_dim, pb.model.input_dim, pb.ocp.n_eq) == (58, 35, 14)
    # both packages solve the same problem
    np.testing.assert_allclose(pb.params.x_ref.numpy(), ref[5], rtol=0, atol=0)
    np.testing.assert_allclose(pb.params.u_ref.numpy(), ref[6], rtol=1e-15, atol=0)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=1),
                            device="cpu")
    sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    got = to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm))
    for name, a, b in zip(("traj.xs", "traj.us", "cost", "g_norm"), got, ref[:4]):
        b = np.asarray(b, np.float64)
        limit = TOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        print(f"humanoid23 N={N} f64 {name}: max|port - JAX| {err:.3e} (limit {limit:.3e})")
        assert err <= limit, f"humanoid23 N={N} f64 {name}: {err:.3e} > {limit:.3e}"
    assert float(sol.step_size) == float(ref[4])
    assert np.isfinite(got[2]) and sol.iterations == 1


def test_humanoid23_graphed_runner_matches_eager_and_jax(jax_solution):
    """The compiled solve's static-buffer runner with capture off
    (`solver/graphs.py`; a CPU has no CUDA graphs) on the same iteration:
    bit for bit the eager solve, and JAX's at the tolerance above."""
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpIteration

    pb = build_wb_problem(ASSETS / "humanoid23", N, device="cpu", dtype=torch.float64,
                          swing=stance_reference(N))
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=1)
    eager = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
    split = GraphedSqpSolve(SqpIteration(pb.ocp, pb.model.flow_map, pb.bp, cfg),
                            torch.device("cpu"), capture=False)
    a = eager(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    b = split(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    for name, x, y in (("xs", a.traj.xs, b.traj.xs), ("us", a.traj.us, b.traj.us),
                       ("lam", a.lam, b.lam), ("cost", a.cost, b.cost),
                       ("g_norm", a.g_norm, b.g_norm), ("defect_norm", a.defect_norm,
                                                         b.defect_norm),
                       ("step_size", a.step_size, b.step_size)):
        assert torch.equal(x, y), f"humanoid23 runner vs eager {name}"
    got = to_numpy((b.traj.xs, b.traj.us, b.cost, b.g_norm))
    for name, x, ref in zip(("traj.xs", "traj.us", "cost", "g_norm"), got, jax_solution[:4]):
        ref = np.asarray(ref, np.float64)
        limit = TOL * max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(np.asarray(x, np.float64) - ref).max())
        assert err <= limit, f"humanoid23 runner {name}: {err:.3e} > {limit:.3e}"
    assert float(b.step_size) == float(jax_solution[4])
