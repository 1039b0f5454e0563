"""PyTorch port, OCP and LQ layer against the JAX package on `toy_biped`:
`WholeBodyOcp.fused_node` (terms and x_dot), the production node
linearization `make_node_lq` ("node" sensitivity, external RK4 tail), and the
equality projection `project_lq` and its one-node closure `project_node`.

Tolerances: f64 rtol 1e-9; f32 1e-3 relative to each output's largest entry
(forward-mode Jacobians of a ~1000-op graph in float32). `project_lq` is
compared on L, w, A', d', Qxx', qx' and on the basis-invariant lifts
Z Zᵀ, B′Zᵀ, Z Quu′ Zᵀ, Z Qux′, Z qu′ — never on Z itself, whose QR column
signs are not unique."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    DTYPES,
    NO_BATCHING_FALLBACK,
    jax_mode,
    jax_wb,
    port_wb,
    to_numpy,
)
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WBNodeParams as JaxParams
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WholeBodyOcp as JaxOcp
from wb_humanoid_mpc_tpu.solver.projection import project_lq as jax_project_lq
from wb_humanoid_mpc_tpu.solver.projection import project_node as jax_project_node
from wb_humanoid_mpc_tpu.solver.transcription import LQApprox as JaxLQ
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu.solver.transcription import make_lq_functions as jax_make_lq_functions
from wb_humanoid_mpc_tpu.solver.transcription import make_node_lq as jax_make_node_lq
from wb_humanoid_mpc_tpu.solver.transcription import rk4_step as jax_rk4_step
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp as PortOcp
from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq, project_node
from wb_humanoid_mpc_tpu_torch.solver.transcription import (
    LQApprox,
    Trajectory,
    make_lq_functions,
    make_node_lq,
    rk4_step,
)

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

TOL = {"f64": 1e-9, "f32": 1e-3}
# per node: both feet in contact (stance), left swing, right swing, stance
CONTACT = np.array([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])


def _scaled_close(got, ref, tol, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=f"{what} {i}")


def _node_inputs(seed):
    cfg, model, _ = jax_wb("toy_biped")
    rng = np.random.default_rng(seed)
    n, nx, nu = len(CONTACT), model.state_dim, model.input_dim
    x = np.asarray(cfg.initial_state) + 0.05 * rng.normal(size=(n, nx))
    u = np.zeros((n, nu))
    u[:, 2] = u[:, 8] = 0.5 * model.robot.total_mass * model.robot.gravity
    u = u + rng.normal(size=(n, nu))
    params = {"contact": CONTACT, "z_pos": 0.02 * rng.normal(size=(n, 2)),
              "z_vel": 0.1 * rng.normal(size=(n, 2)), "z_acc": rng.normal(size=(n, 2)),
              "proximity": rng.uniform(0.3, 1.0, size=(n, 2)),
              "x_ref": np.asarray(cfg.initial_state) + 0.01 * rng.normal(size=(n, nx)),
              "u_ref": u - rng.normal(size=(n, nu))}
    lam = 0.1 * rng.normal(size=(n, 14))
    return x, u, params, lam


def _jax_args(x, u, params, lam, dtype):
    jdt = DTYPES[dtype][0]
    return (jnp.zeros(len(x), jdt), jnp.asarray(x, jdt), jnp.asarray(u, jdt),
            JaxParams(**{k: jnp.asarray(v, jdt) for k, v in params.items()}),
            jnp.asarray(lam, jdt))


def _port_args(x, u, params, lam, dtype):
    tdt = DTYPES[dtype][1]
    return (torch.zeros(len(x), dtype=tdt), torch.as_tensor(x, dtype=tdt),
            torch.as_tensor(u, dtype=tdt),
            convert.node_params_from_numpy(params, device="cpu", dtype=tdt),
            torch.as_tensor(lam, dtype=tdt))


def _ocps(torque_cost: bool):
    """(JAX, port) OCPs of `toy_biped`; with `torque_cost`, the optional
    joint-torque cost rows (`wb_ocp.py:159-163`: full M, Newton-Euler nle,
    joint torques) switched on with the same weights in both."""
    jcfg, jmodel, jocp = jax_wb("toy_biped")
    tcfg, tmodel, tocp = port_wb("toy_biped")
    if not torque_cost:
        return jocp, tocp
    w = np.linspace(1e-3, 2e-3, jmodel.layout.n_joints)
    return (JaxOcp(model=jmodel, cfg=dataclasses.replace(jcfg, joint_torque_weights=w)),
            PortOcp(model=tmodel, cfg=dataclasses.replace(tcfg, joint_torque_weights=w)))


@pytest.mark.parametrize("torque_cost", [False, True], ids=["no_torque_cost", "torque_cost"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fused_node(dtype, torque_cost):
    x, u, params, lam = _node_inputs(0)
    jocp, tocp = _ocps(torque_cost)
    with jax_mode(dtype):
        t, jx, ju, jp, _ = _jax_args(x, u, params, lam, dtype)
        terms, xdot = jax.vmap(jocp.fused_node)(t, jx, ju, jp)
        ref = to_numpy(list(terms) + [xdot])
    t, tx, tu, tp, _ = _port_args(x, u, params, lam, dtype)
    terms, xdot = tocp.fused_node(t, tx, tu, tp)
    _scaled_close(to_numpy(list(terms) + [xdot]), ref, TOL[dtype], "fused_node")
    # swing nodes carry the zero-wrench rows, stance nodes the foot rows
    assert ref[4].shape == (len(CONTACT), 14)
    n_r = 36 + 24 + 2 * 18 + (12 if torque_cost else 0)
    assert ref[0].shape == (len(CONTACT), n_r)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_rk4_defects_and_joint_torques(dtype):
    """`rk4_step`, the shooting `defects` of `make_lq_functions` (RK4 tail
    through `flow_map_batch`) and `WholeBodyModel.joint_torques`."""
    jcfg, jmodel, jocp = jax_wb("toy_biped")
    _, tmodel, tocp = port_wb("toy_biped")
    N, dt = 3, jcfg.sqp.dt
    x, u, _, _ = _node_inputs(3)
    xs, us = x[: N + 1], u[:N]
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        jxs, jus = jnp.asarray(xs, jdt), jnp.asarray(us, jdt)
        times = dt * jnp.arange(N + 1, dtype=jdt)
        x_next = jax.vmap(lambda t, x_, u_: jax_rk4_step(jmodel.flow_map, t, x_, u_, dt))(
            times[:-1], jxs[:-1], jus)
        defects = jax_make_lq_functions(jocp, jmodel.flow_map, dt, N, jocp.barrier_params(),
                                        sensitivity="node")[2]
        ref = to_numpy([x_next, defects(JaxTrajectory(xs=jxs, us=jus), times),
                        jax.vmap(jmodel.joint_torques)(jxs[:-1], jus)])
    txs, tus = torch.as_tensor(xs, dtype=tdt), torch.as_tensor(us, dtype=tdt)
    times = dt * torch.arange(N + 1, dtype=tdt)
    port_defects = make_lq_functions(tocp, tmodel.flow_map, dt, N,
                                     tocp.barrier_params("cpu", tdt),
                                     flow_batch=tmodel.flow_map_batch).defects
    got = to_numpy([rk4_step(tmodel.flow_map, times[:-1], txs[:-1], tus, dt),
                    port_defects(Trajectory(xs=txs, us=tus), times),
                    tmodel.joint_torques(txs[:-1], tus)])
    _scaled_close(got, ref, TOL[dtype], "rk4 / defects / joint torques")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_make_node_lq(dtype):
    """All 15 outputs: A_d, B_d, k1, Qxx, Quu, Qux, qx, qu, cost, g_max, g,
    Cx, Du, cost_pure, g_sse."""
    x, u, params, lam = _node_inputs(1)
    jcfg, jmodel, jocp = jax_wb("toy_biped")
    _, _, tocp = port_wb("toy_biped")
    dt, rho = jcfg.sqp.dt, 1.0
    with jax_mode(dtype):
        node_lq = jax_make_node_lq(jocp, jmodel.flow_map, dt, jocp.barrier_params(),
                                   sensitivity="node", external_tail=True)
        t, jx, ju, jp, jl = _jax_args(x, u, params, lam, dtype)
        ref = to_numpy(jax.jit(jax.vmap(node_lq, in_axes=(0, 0, 0, 0, 0, None)))(
            t, jx, ju, jp, jl, rho))
    tdt = DTYPES[dtype][1]
    port_lq = make_node_lq(tocp, tocp.model.flow_map, dt, tocp.barrier_params("cpu", tdt),
                           sensitivity="node")
    got = to_numpy(port_lq(*_port_args(x, u, params, lam, dtype), rho))
    assert len(got) == len(ref) == 15
    _scaled_close(got, ref, TOL[dtype], "make_node_lq")


def _proj_data(seed, dtype):
    rng = np.random.default_rng(seed)
    N, nx, nu, nc = 4, 12, 10, 4
    A = np.eye(nx) + 0.05 * rng.normal(size=(N, nx, nx))
    B = 0.1 * rng.normal(size=(N, nx, nu))
    Wx, Wu = rng.normal(size=(N, nx, nx)), rng.normal(size=(N, nu, nu))
    Qxx = Wx @ np.swapaxes(Wx, 1, 2) / nx + np.eye(nx)
    Quu = Wu @ np.swapaxes(Wu, 1, 2) / nu + np.eye(nu)
    Cx, Du, g = rng.normal(size=(N, nc, nx)), rng.normal(size=(N, nc, nu)), rng.normal(size=(N, nc))
    # a masked (all-zero) constraint row, as a stance foot's swing row is
    Cx[1, 3], Du[1, 3], g[1, 3] = 0.0, 0.0, 0.0
    d = dict(A=A, B=B, d=0.01 * rng.normal(size=(N, nx)), Qxx=Qxx, Quu=Quu,
             Qux=0.1 * rng.normal(size=(N, nu, nx)), qx=rng.normal(size=(N, nx)),
             qu=rng.normal(size=(N, nu)), QN=np.eye(nx), qN=rng.normal(size=nx))
    return d, Cx, Du, g


def _proj_outputs(red, proj, mm, T):
    Z = proj.Z
    return [proj.L, proj.w, red.A, red.d, red.Qxx, red.qx,
            mm(Z, T(Z)), mm(red.B, T(Z)), mm(mm(Z, red.Quu), T(Z)), mm(Z, red.Qux),
            mm(Z, red.qu[..., None])]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_project_lq(dtype):
    d, Cx, Du, g = _proj_data(2, dtype)
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        jlq = JaxLQ(**{k: jnp.asarray(v, jdt) for k, v in d.items()},
                    cost=0.0, g_norm=0.0, defect_norm=0.0)
        red, proj = jax_project_lq(jlq, jnp.asarray(Cx, jdt), jnp.asarray(Du, jdt),
                                   jnp.asarray(g, jdt), 1e-8)
        ref = to_numpy(_proj_outputs(red, proj, jnp.matmul, lambda a: jnp.swapaxes(a, -1, -2)))
    tlq = LQApprox(**{k: torch.as_tensor(v, dtype=tdt) for k, v in d.items()})
    red, proj = project_lq(tlq, *(torch.as_tensor(a, dtype=tdt) for a in (Cx, Du, g)), 1e-8)
    got = to_numpy(_proj_outputs(red, proj, torch.matmul, lambda a: a.transpose(-1, -2)))
    _scaled_close(got, ref, {"f64": 1e-9, "f32": 1e-4}[dtype], "project_lq")


NODE_FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu")


def _node_outputs(out, mm, T):
    """project_node's (A', B', d', Qxx', Quu', Qux', qx', qu', L, Z, w) as
    `_proj_outputs` compares them: Z only through basis-invariant lifts."""
    A, B, d, Qxx, Quu, Qux, qx, qu, L, Z, w = out
    return [L, w, A, d, Qxx, qx, mm(Z, T(Z)), mm(B, T(Z)), mm(mm(Z, Quu), T(Z)), mm(Z, Qux),
            mm(Z, qu[..., None])]


@pytest.mark.parametrize("node", [0, 1, 3], ids=["node0", "masked_row", "node3"])
def test_project_node_matches_jax(node):
    """JAX's `project_node(eps)` on one random stage in f64, to 1e-12; node 1
    carries a masked (all-zero) row of [g, Cx, Du]."""
    d, Cx, Du, g = _proj_data(2, "f64")
    args = [d[k][node] for k in NODE_FIELDS] + [Cx[node], Du[node], g[node]]
    if node == 1:
        assert not Du[1, 3].any() and not Cx[1, 3].any() and g[1, 3] == 0.0
    with jax_mode("f64"):
        out = jax_project_node(1e-8)(*(jnp.asarray(a) for a in args))
        ref = to_numpy(_node_outputs(out, jnp.matmul, lambda a: jnp.swapaxes(a, -1, -2)))
    out = project_node(1e-8)(*(torch.as_tensor(a) for a in args))
    assert len(out) == 11
    got = to_numpy(_node_outputs(out, torch.matmul, lambda a: a.transpose(-1, -2)))
    _scaled_close(got, ref, 1e-12, f"project_node node {node}")


def test_project_node_is_a_row_of_project_lq():
    """`project_node` on node k equals row k of the port's `project_lq`."""
    d, Cx, Du, g = _proj_data(3, "f64")
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    Cx, Du, g = (torch.as_tensor(a) for a in (Cx, Du, g))
    red, proj = project_lq(LQApprox(**t), Cx, Du, g, 1e-8)
    rows = (*red[:8], *proj)
    one = project_node(1e-8)
    for k in range(Cx.shape[0]):
        out = one(*(t[f][k] for f in NODE_FIELDS), Cx[k], Du[k], g[k])
        for a, b in zip(out, rows):
            torch.testing.assert_close(a, b[k], rtol=0.0, atol=0.0)
