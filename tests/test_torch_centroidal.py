"""PyTorch port, the centroidal formulation against the JAX package on
`toy_biped` and `humanoid23` (the committed `task_centroidal.info` of each):
the rigid-body helpers it adds to `models/dynamics.py`, `CentroidalModel`
(flow map, momentum matrix, its SRBM variant), `CentroidalOcp.fused_node`,
`make_centroidal_node_params`, the production node linearization
(`make_node_lq`, "node" sensitivity) and one SQP iteration of the
centroidal problem on `toy_biped` at N = 6.

Tolerances: node-level outputs f64 1e-10 max(1, max|ref|), f32 2e-3
max(1, max|ref|), per output; the SQP iteration f64 1e-6 max(1, max|ref|)
(the tolerance of tests/test_torch_variants*.py) and the same step."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    DTYPES,
    NO_BATCHING_FALLBACK,
    jax_centroidal,
    jax_mode,
    port_centroidal,
    to_numpy,
)
from wb_humanoid_mpc_tpu.models import dynamics as jdyn
from wb_humanoid_mpc_tpu.models import kinematics as jkin
from wb_humanoid_mpc_tpu.ocp.centroidal_ocp import NodeParams as JaxParams
from wb_humanoid_mpc_tpu.ocp.params import make_centroidal_node_params as jax_node_params
from wb_humanoid_mpc_tpu.refs.swing import SwingReference as JaxSwing
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.sqp import make_sqp_solver as jax_make_sqp_solver
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu.solver.transcription import make_node_lq as jax_make_node_lq
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.interface import stance_reference, walking_reference
from wb_humanoid_mpc_tpu_torch.models import dynamics as tdyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as tkin
from wb_humanoid_mpc_tpu_torch.ocp.params import make_centroidal_node_params
from wb_humanoid_mpc_tpu_torch.refs.swing import SwingReference
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory, make_node_lq

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

TOL = {"f64": 1e-10, "f32": 2e-3}
ROBOTS = ["toy_biped", "humanoid23"]
# per node: stance, left swing, right swing, stance
CONTACT = np.array([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])


def _scaled_close(got, ref, tol, what):
    assert len(got) == len(ref), what
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, f"{what} {i}: {a.shape} vs {b.shape}"
        if not b.size:
            continue
        limit = tol * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= limit, f"{what} output {i}: {err:.3e} > {limit:.3e}"


def _inputs(robot, seed, n=len(CONTACT)):
    """Node states, inputs and params near the robot's standing pose."""
    cfg, model, ocp = jax_centroidal(robot)
    rng = np.random.default_rng(seed)
    nx, nu = model.state_dim, model.input_dim
    x = np.asarray(cfg.initial_state) + 0.05 * rng.normal(size=(n, nx))
    u = np.zeros((n, nu))
    u[:, 2] = u[:, 8] = 0.5 * model.robot.total_mass * model.robot.gravity
    u = u + rng.normal(size=(n, nu))
    n_ts = len(cfg.task_space_costs)
    R = np.linalg.qr(rng.normal(size=(n, n_ts, 3, 3)))[0]
    torso = np.concatenate([rng.normal(size=(n, n_ts, 3)), R.reshape(n, n_ts, 9),
                            0.1 * rng.normal(size=(n, n_ts, 6))], axis=-1)
    params = {"contact": np.resize(CONTACT, (n, 2)), "z_pos": 0.02 * rng.normal(size=(n, 2)),
              "z_vel": 0.1 * rng.normal(size=(n, 2)),
              "proximity": rng.uniform(0.3, 1.0, size=(n, 2)),
              "x_ref": np.asarray(cfg.initial_state) + 0.01 * rng.normal(size=(n, nx)),
              "u_ref": u - rng.normal(size=(n, nu)), "torso_ref": torso}
    lam = 0.1 * rng.normal(size=(n, ocp.n_eq))
    return x, u, params, lam


def _jax_params(params, jdt):
    return JaxParams(**{k: jnp.asarray(v, jdt) for k, v in params.items()})


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_dynamics_helpers(robot, dtype):
    """com_position, mass_matrix, mass_and_nle (M, nle), nonlinear_effects,
    centroidal_momentum_matrix, normalized_centroidal_momentum and
    generalized_accelerations, per node against JAX's vmapped functions."""
    _, jmodel, _ = jax_centroidal(robot)
    _, tmodel, _ = port_centroidal(robot)
    rng = np.random.default_rng(5)
    n, nq = 3, jmodel.robot.nq
    q = 0.3 * rng.normal(size=(n, nq))
    q[:, 2] += 0.8
    v, qdd = rng.normal(size=(n, nq)), rng.normal(size=(n, nq - 6))
    W = rng.normal(size=(n, 2, 6)) * np.array([10, 10, 100, 1, 1, 1])
    frames = jmodel.contact_frames
    jdt, tdt = DTYPES[dtype]

    def jfun(q_, v_, qdd_, W_):
        rob = jmodel.robot
        mn = jdyn.mass_and_nle(rob, q_, v_)
        fk = jkin.forward_kinematics(rob, q_)
        Jc = jnp.stack([jkin.frame_jacobian(rob, fk, f) for f in frames])
        return (jdyn.com_position(rob, q_), jdyn.mass_matrix(rob, q_), mn.M, mn.nle,
                jdyn.nonlinear_effects(rob, q_, v_), jdyn.centroidal_momentum_matrix(rob, q_),
                jdyn.normalized_centroidal_momentum(rob, q_, v_),
                jdyn.generalized_accelerations(rob, mn.M, mn.nle, qdd_, Jc, W_))

    with jax_mode(dtype):
        ref = to_numpy(jax.jit(jax.vmap(jfun))(*(jnp.asarray(a, jdt) for a in (q, v, qdd, W))))
    rob = tmodel.robot
    tq, tv, tqdd, tW = (torch.as_tensor(a, dtype=tdt) for a in (q, v, qdd, W))
    mn = tdyn.mass_and_nle(rob, tq, tv)
    fk = tkin.forward_kinematics(rob, tq)
    Jc = torch.stack([tkin.frame_jacobian(rob, fk, f) for f in frames], dim=-3)
    got = to_numpy((tdyn.com_position(rob, tq), tdyn.mass_matrix(rob, tq), mn.M, mn.nle,
                    tdyn.nonlinear_effects(rob, tq, tv), tdyn.centroidal_momentum_matrix(rob, tq),
                    tdyn.normalized_centroidal_momentum(rob, tq, tv),
                    tdyn.generalized_accelerations(rob, mn.M, mn.nle, tqdd, Jc, tW)))
    _scaled_close(got, ref, TOL[dtype], f"dynamics {robot}")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("srbm", [False, True], ids=["full", "srbm"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_flow_map_and_momentum_matrix(robot, srbm, dtype):
    """The flow map, the momentum matrix (SRBM: at the nominal joints, joint
    columns zero), the generalized velocity and the (q, v) -> state map."""
    _, jmodel, _ = jax_centroidal(robot, srbm)
    _, tmodel, _ = port_centroidal(robot, srbm)
    x, u, _, _ = _inputs(robot, 0)
    v = np.random.default_rng(1).normal(size=(len(x), jmodel.robot.nq))
    lay = jmodel.layout
    jdt, tdt = DTYPES[dtype]

    def jfun(x_, u_, v_):
        q = lay.generalized_coordinates(x_)
        return (jmodel.flow_map(0.0, x_, u_), jmodel._momentum_matrix(q),
                jmodel.generalized_velocity(x_, lay.joint_input(u_)),
                jmodel.state_from_generalized(q, v_))

    with jax_mode(dtype):
        ref = to_numpy(jax.jit(jax.vmap(jfun))(*(jnp.asarray(a, jdt) for a in (x, u, v))))
    tx, tu, tv = (torch.as_tensor(a, dtype=tdt) for a in (x, u, v))
    q = tmodel.layout.generalized_coordinates(tx)
    got = to_numpy((tmodel.flow_map(0.0, tx, tu), tmodel._momentum_matrix(q),
                    tmodel.generalized_velocity(tx, tmodel.layout.joint_input(tu)),
                    tmodel.state_from_generalized(q, tv)))
    _scaled_close(got, ref, TOL[dtype], f"flow/momentum {robot} srbm={srbm}")
    if srbm:
        assert np.abs(ref[1][:, :, 6:]).max() == 0.0


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_fused_node(robot, dtype):
    """NodeTerms (r, h_log, h_log_mask, h_quad, g) and x_dot, over stance and
    swing nodes; x_dot equals the flow map."""
    _, _, jocp = jax_centroidal(robot)
    _, tmodel, tocp = port_centroidal(robot)
    x, u, params, _ = _inputs(robot, 2)
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        terms, xdot = jax.jit(jax.vmap(jocp.fused_node))(
            jnp.zeros(len(x), jdt), jnp.asarray(x, jdt), jnp.asarray(u, jdt),
            _jax_params(params, jdt))
        ref = to_numpy(list(terms) + [xdot])
    tx, tu = torch.as_tensor(x, dtype=tdt), torch.as_tensor(u, dtype=tdt)
    tp = convert.centroidal_node_params_from_numpy(params, device="cpu", dtype=tdt)
    terms, xdot = tocp.fused_node(torch.zeros(len(x), dtype=tdt), tx, tu, tp)
    got = to_numpy(list(terms) + [xdot])
    _scaled_close(got, ref, TOL[dtype], f"fused_node {robot}")
    _scaled_close([xdot.numpy()], [to_numpy(tmodel.flow_map(0.0, tx, tu))], TOL[dtype],
                  "x_dot vs flow_map")
    assert ref[4].shape == (len(x), tocp.n_eq)
    # swing nodes hold the zero-wrench rows, stance nodes the twist rows
    assert ref[2].shape == (len(x), 10)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_node_params(robot, dtype):
    """make_centroidal_node_params: contact/swing arrays, weight-comp u_ref
    and the task-space link references from one batched FK pass."""
    _, _, jocp = jax_centroidal(robot)
    _, _, tocp = port_centroidal(robot)
    x, _, params, _ = _inputs(robot, 3, n=7)
    rng = np.random.default_rng(4)
    swing = dict(contact_flags=params["contact"], z_pos=params["z_pos"],
                 z_vel=params["z_vel"], z_acc=rng.normal(size=(7, 2)),
                 proximity=params["proximity"])
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        ref = to_numpy(list(jax_node_params(jocp, JaxSwing(**swing), jnp.asarray(x, jdt))))
    got = to_numpy(list(make_centroidal_node_params(tocp, SwingReference(**swing),
                                                    torch.as_tensor(x, dtype=tdt))))
    _scaled_close(got, ref, TOL[dtype], f"node params {robot}")
    assert ref[-1].shape == (7, 1, 18)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_make_node_lq(robot, dtype):
    """All 15 outputs of the node linearization ("node" sensitivity, k1 in
    the x_next slot): A_d, B_d, k1, Qxx, Quu, Qux, qx, qu, cost, g_max, g,
    Cx, Du, cost_pure, g_sse."""
    jcfg, jmodel, jocp = jax_centroidal(robot)
    _, tmodel, tocp = port_centroidal(robot)
    x, u, params, lam = _inputs(robot, 6)
    dt, rho = jcfg.sqp.dt, 1.0
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        node_lq = jax_make_node_lq(jocp, jmodel.flow_map, dt, jocp.barrier_params(),
                                   sensitivity="node", external_tail=True)
        ref = to_numpy(jax.jit(jax.vmap(node_lq, in_axes=(0, 0, 0, 0, 0, None)))(
            jnp.zeros(len(x), jdt), jnp.asarray(x, jdt), jnp.asarray(u, jdt),
            _jax_params(params, jdt), jnp.asarray(lam, jdt), rho))
    port_lq = make_node_lq(tocp, tmodel.flow_map, dt, tocp.barrier_params("cpu", tdt),
                           sensitivity="node")
    got = to_numpy(port_lq(torch.zeros(len(x), dtype=tdt), torch.as_tensor(x, dtype=tdt),
                           torch.as_tensor(u, dtype=tdt),
                           convert.centroidal_node_params_from_numpy(params, device="cpu",
                                                                     dtype=tdt),
                           torch.as_tensor(lam, dtype=tdt), rho))
    assert len(got) == len(ref) == 15
    _scaled_close(got, ref, TOL[dtype], f"make_node_lq {robot}")


N = 6
SETUPS = {"stance": stance_reference, "walk": walking_reference}


@pytest.fixture(scope="module")
def jax_sqp():
    """{setup: (xs, us, cost, g_norm, step_size, params as numpy)}: one JAX
    SQP iteration of the toy_biped centroidal problem, f64."""
    cfg, model, ocp = jax_centroidal("toy_biped")
    solve = jax.jit(jax_make_sqp_solver(ocp, model.flow_map, ocp.barrier_params(),
                                        JaxConfig(n_nodes=N, dt=cfg.sqp.dt)))
    out = {}
    for setup, reference in SETUPS.items():
        r = reference(N)
        x0 = jnp.asarray(cfg.initial_state)
        params = jax_node_params(ocp, JaxSwing(r.contact_flags, r.z_pos, r.z_vel, r.z_acc,
                                               r.proximity), jnp.tile(x0, (N + 1, 1)))
        u0 = np.asarray(params.u_ref[:N])
        sol = solve(0.0, x0, JaxTrajectory(xs=jnp.tile(x0, (N + 1, 1)), us=jnp.asarray(u0)),
                    params, jnp.zeros((N, ocp.n_eq)))
        out[setup] = (to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm,
                                sol.step_size)), {k: np.asarray(v) for k, v in
                                                  params._asdict().items()})
    return out


@pytest.mark.parametrize("setup", list(SETUPS))
def test_sqp_iteration(jax_sqp, setup):
    """One warm-started SQP iteration (projection + filter, K1's plain
    version on the CPU) from the same params, f64."""
    ref, params = jax_sqp[setup]
    cfg, model, ocp = port_centroidal("toy_biped")
    tdt = torch.float64
    solve = make_sqp_solver(ocp, model.flow_map, ocp.barrier_params("cpu", tdt),
                            SqpSolverConfig(n_nodes=N, dt=cfg.sqp.dt), device="cpu")
    tp = convert.centroidal_node_params_from_numpy(params, device="cpu", dtype=tdt)
    x0 = torch.as_tensor(cfg.initial_state, dtype=tdt)
    xs = x0.expand(N + 1, -1).clone()
    sol = solve(0.0, x0, Trajectory(xs=xs, us=tp.u_ref[:N].clone()), tp,
                torch.zeros(N, ocp.n_eq, dtype=tdt))
    got = to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm))
    for name, a, b in zip(("xs", "us", "cost", "g_norm"), got, ref[:4]):
        limit = 1e-6 * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= limit, f"{setup} {name}: {err:.3e} > {limit:.3e}"
    assert float(sol.step_size) == float(ref[4])
    assert float(ref[4]) > 0.0
