"""PyTorch port, the Gauss-Newton DDP solver (`solver/ddp.py`) against JAX's
`make_ddp_solver` on the whole-body `toy_biped` problem, N = 6, stance and
walk, with the AL multiplier update and three iterations (the setup of
tests/test_variants.py:67-86, on the port's robot), f64; and its single
shooting: the result rolls out exactly under RK4.

Tolerances: f64 1e-6 x max(1, max|ref|), the same step
(tests/test_torch_sqp.py); the rollout identity at atol 1e-10
(tests/test_variants.py)."""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_common import (
    NO_BATCHING_FALLBACK,
    assert_solution_close,
    jax_solutions,
    port_problem,
)
from wb_humanoid_mpc_tpu.solver.ddp import make_ddp_solver as jax_make_ddp_solver
from wb_humanoid_mpc_tpu_torch.solver.ddp import make_ddp_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig
from wb_humanoid_mpc_tpu_torch.solver.transcription import rk4_step

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
FIELDS = dict(equality_handling="al", rho=1e3, sqp_iterations=3)


@pytest.fixture(scope="module")
def jax_refs():
    return jax_solutions(jax_make_ddp_solver, FIELDS, N)


@pytest.mark.parametrize("setup", ["stance", "walk"])
def test_ddp_matches_jax(jax_refs, setup):
    pb = port_problem(setup, N, "f64")
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, **FIELDS)
    sol = make_ddp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")(
        0.0, pb.x0, pb.traj, pb.params, pb.lam)
    assert_solution_close(sol, jax_refs[(setup, "f64")], "f64", f"ddp {setup}")
    assert sol.iterations == 3 and float(sol.defect_norm) == 0.0
    xs, us = sol.traj.xs, sol.traj.us
    times = cfg.dt * torch.arange(N, dtype=xs.dtype)
    torch.testing.assert_close(rk4_step(pb.model.flow_map, times, xs[:-1], us, cfg.dt), xs[1:],
                               rtol=0.0, atol=1e-10)
    torch.testing.assert_close(xs[0], pb.x0, rtol=0.0, atol=0.0)
