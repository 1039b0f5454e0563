"""PyTorch port, the SQP solver's configurations beyond the production path,
each against JAX's `make_sqp_solver` on `toy_biped`, N = 6, stance and walk,
two SQP iterations (the AL multipliers and the safeguard's g_prev carry from
one to the next). This file: the AL equality path and the merit line
search; the LQ closures the merit reads (`total_cost`, `defects`,
`cost_and_violation`); the staged solver against the fused one. The other
configurations are in tests/test_torch_variants_*.py, one JAX compile pair
per file, so that `--dist loadfile` spreads them.

Tolerances: whole solves f64 1e-6 and f32 2e-3 x max(1, max|ref|), the same
step (tests/test_torch_sqp.py); the LQ closures f64 rtol 1e-9, f32 1e-4 x
max(1, max|ref|)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    DTYPES,
    NO_BATCHING_FALLBACK,
    check_variant,
    jax_mode,
    jax_solutions,
    jax_wb,
    port_problem,
    port_wb,
    to_numpy,
)
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WBNodeParams as JaxParams
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu.solver.transcription import make_lq_functions as jax_make_lq_functions
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    PhaseTimings,
    SqpSolverConfig,
    make_sqp_solver,
    make_staged_sqp_solver,
)
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory, make_lq_functions

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
VARIANTS = {"al": dict(equality_handling="al", sqp_iterations=2),
            "merit": dict(line_search="merit", sqp_iterations=2)}


@pytest.fixture(scope="module")
def jax_refs():
    return {name: jax_solutions(jax_make_sqp_solver, fields, N)
            for name, fields in VARIANTS.items()}


@pytest.mark.parametrize("setup", ["stance", "walk"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sqp_variant_matches_jax(jax_refs, variant, setup):
    check_variant(jax_refs[variant], VARIANTS[variant], setup, "f64", N)


def _trajectories(seed, n_cand=2):
    """n_cand random trajectories near the initial state, params of the walk
    schedule, multipliers: numpy."""
    cfg, model, _ = jax_wb("toy_biped")
    rng = np.random.default_rng(seed)
    nx, nu = model.state_dim, model.input_dim
    xs = np.asarray(cfg.initial_state) + 0.02 * rng.normal(size=(n_cand, N + 1, nx))
    us = np.zeros((n_cand, N, nu))
    us[..., 2] = us[..., 8] = 0.5 * model.robot.total_mass * model.robot.gravity
    us = us + rng.normal(size=(n_cand, N, nu))
    pb = port_problem("walk", N, "f64")
    params = {f: getattr(pb.params, f).numpy() for f in pb.params._fields}
    return xs, us, params, 0.1 * rng.normal(size=(N, 14))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("fn", ["total_cost", "defects", "cost_and_violation"])
def test_lq_closures_match_jax(fn, dtype):
    """Each closure on one trajectory against JAX's, and on a stack of two
    (the merit's leading candidate dim) against JAX's vmap."""
    xs, us, params, lam = _trajectories(7)
    jcfg, jmodel, jocp = jax_wb("toy_biped")
    _, _, tocp = port_wb("toy_biped")
    dt, rho = jcfg.sqp.dt, 1e3
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        fns = jax_make_lq_functions(jocp, jmodel.flow_map, dt, N, jocp.barrier_params(),
                                    sensitivity="node")
        jfn = {"total_cost": lambda tr, t, p: fns[1](tr, t, p, jnp.asarray(lam, jdt), rho),
               "defects": lambda tr, t, p: fns[2](tr, t),
               "cost_and_violation": fns[4]}[fn]
        times = dt * jnp.arange(N + 1, dtype=jdt)
        jp = JaxParams(**{k: jnp.asarray(v, jdt) for k, v in params.items()})
        ref = to_numpy(jax.jit(jax.vmap(lambda x, u: jfn(JaxTrajectory(xs=x, us=u), times, jp)))(
            jnp.asarray(xs, jdt), jnp.asarray(us, jdt)))
    tfns = make_lq_functions(tocp, tocp.model.flow_map, dt, N, tocp.barrier_params("cpu", tdt),
                             sensitivity="node", flow_batch=tocp.model.flow_map_batch)
    tfn = {"total_cost": lambda tr, t, p: tfns.total_cost(tr, t, p, torch.as_tensor(lam, dtype=tdt),
                                                          rho),
           "defects": lambda tr, t, p: tfns.defects(tr, t),
           "cost_and_violation": tfns.cost_and_violation}[fn]
    times = dt * torch.arange(N + 1, dtype=tdt)
    tp = convert.node_params_from_numpy(params, device="cpu", dtype=tdt)
    stacked = to_numpy(tfn(Trajectory(xs=torch.as_tensor(xs, dtype=tdt),
                                      us=torch.as_tensor(us, dtype=tdt)), times, tp))
    single = to_numpy(tfn(Trajectory(xs=torch.as_tensor(xs[0], dtype=tdt),
                                     us=torch.as_tensor(us[0], dtype=tdt)), times, tp))
    if fn == "defects":   # one array, not a tuple of outputs
        stacked, single, ref = [stacked], [single], [ref]
    tol = {"f64": 1e-9, "f32": 1e-4}[dtype]
    for i, (a, b) in enumerate(zip(stacked, ref)):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=f"{fn} {i}")
        np.testing.assert_allclose(single[i], b[0], rtol=tol, atol=tol * scale,
                                   err_msg=f"{fn} {i}, one trajectory")


@pytest.mark.parametrize("setup", ["stance", "walk"])
def test_staged_solver_equals_fused(setup):
    """`make_staged_sqp_solver` (every step evaluated at once, each phase
    timed) takes the fused solver's steps: the same trajectory, cost, g_norm
    and step over two iterations; its four phase times are non-negative."""
    pb = port_problem(setup, N, "f64")
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=2)
    ref = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")(
        0.0, pb.x0, pb.traj, pb.params, pb.lam)
    sol, phases = make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")(
        0.0, pb.x0, pb.traj, pb.params, pb.lam)
    assert isinstance(phases, PhaseTimings) and min(phases) >= 0.0 and sum(phases) > 0.0
    for name, a, b in (("xs", sol.traj.xs, ref.traj.xs), ("us", sol.traj.us, ref.traj.us),
                       ("cost", sol.cost, ref.cost), ("g_norm", sol.g_norm, ref.g_norm)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
    assert float(sol.step_size) == float(ref.step_size)
    assert float(sol.defect_norm) >= 0.0 and sol.iterations == 2


def test_staged_solver_refuses_the_al_path():
    pb = port_problem("stance", N, "f64")
    with pytest.raises(ValueError, match="projection path"):
        make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                               SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt,
                                               equality_handling="al"), device="cpu")
