"""PyTorch port, model layer: URDF/config parsing, `convert.py`, rotations,
kinematics and Jacobians against the JAX package (tests/test_torch_common.py).

Tolerances: parsing is exact (the port keeps numpy copies of the parsers);
kinematics agree to atol 1e-12 in f64 and 2e-6 in f32 (the FK-kernel
tolerance of tests/test_ops_fkvel.py:49)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, check_pair, jax_wb, port_wb
from wb_humanoid_mpc_tpu.models import kinematics as jkin
from wb_humanoid_mpc_tpu.utils import rotations as jrot
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.models import kinematics as tkin
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import load_robot_model
from wb_humanoid_mpc_tpu_torch.utils import rotations as trot

ROBOTS = ["toy_biped", "humanoid23"]
KIN_TOL = {"f64": dict(rtol=0.0, atol=1e-12), "f32": dict(rtol=0.0, atol=2e-6)}
_ROBOT_ARRAYS = ("joint_parent_body", "joint_R", "joint_p", "joint_axis", "joint_lower",
                 "joint_upper", "joint_velocity_limit", "joint_effort_limit", "mass", "com",
                 "inertia_o", "ancestor_mask")


def _assert_same_robot(a, b):
    for f in _ROBOT_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype, f
    assert a.joint_names == b.joint_names and a.body_names == b.body_names
    assert a.gravity == b.gravity
    assert sorted(a.frames) == sorted(b.frames)
    for name, fa in a.frames.items():
        fb = b.frames[name]
        assert fa.body == fb.body, name
        np.testing.assert_array_equal(fa.R, fb.R, err_msg=name)
        np.testing.assert_array_equal(fa.p, fb.p, err_msg=name)


def _assert_same_tree(a, b, path="cfg"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("robot", ROBOTS)
def test_urdf_and_config_parse_identical(robot):
    jcfg, jmodel, _ = jax_wb(robot)
    tcfg, tmodel, _ = port_wb(robot)
    _assert_same_robot(jmodel.robot, tmodel.robot)
    _assert_same_tree(dataclasses.asdict(jcfg), dataclasses.asdict(tcfg))
    # the full-joint (no fixed joints) parse too
    from wb_humanoid_mpc_tpu.models.robot.urdf import load_robot_model as jload
    urdf = str(ASSETS / robot / f"{robot}.urdf")
    _assert_same_robot(jload(urdf), load_robot_model(urdf))


@pytest.mark.parametrize("robot,dims", [("toy_biped", (36, 24, 14, 10)),
                                        ("humanoid23", (58, 35, 14, 21))])
def test_problem_dims(robot, dims):
    _, model, ocp = port_wb(robot)
    nx, nu, n_eq, nz = dims
    assert (model.state_dim, model.input_dim, ocp.n_eq, model.input_dim - ocp.n_eq) == dims
    assert model.robot.n_joints == (nx - 12) // 2
    # the URDF fixed joints are lumped: total mass equals the all-joint parse
    urdf = str(ASSETS / robot / f"{robot}.urdf")
    np.testing.assert_allclose(model.robot.total_mass, load_robot_model(urdf).total_mass,
                               rtol=1e-12)
    if robot == "humanoid23":
        assert 30.0 < model.robot.total_mass < 40.0
        assert model.robot.n_bodies == 24


@pytest.mark.parametrize("robot", ROBOTS)
def test_convert_round_trip(robot):
    _, jmodel, _ = jax_wb(robot)
    r = jmodel.robot
    arrays = {f: getattr(r, f) for f in _ROBOT_ARRAYS}
    arrays.update(name=r.name, joint_names=r.joint_names, body_names=r.body_names,
                  frames=r.frames, gravity=r.gravity)
    _assert_same_robot(convert.robot_model_from_arrays(arrays), port_wb(robot)[1].robot)

    rng = np.random.default_rng(0)
    N, nx, nu = 4, jmodel.state_dim, jmodel.input_dim
    params = {"contact": rng.integers(0, 2, size=(N + 1, 2)).astype(float),
              **{k: rng.normal(size=(N + 1, 2)) for k in ("z_pos", "z_vel", "z_acc",
                                                         "proximity")},
              "x_ref": rng.normal(size=(N + 1, nx)), "u_ref": rng.normal(size=(N + 1, nu))}
    p = convert.node_params_from_numpy(params, device="cpu", dtype=torch.float64)
    for k, v in params.items():
        np.testing.assert_array_equal(getattr(p, k).numpy(), v)
    xs, us = rng.normal(size=(N + 1, nx)), rng.normal(size=(N, nu))
    tr = convert.trajectory_from_numpy(xs, us, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tr.xs.numpy(), xs)
    np.testing.assert_array_equal(tr.us.numpy(), us)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_rotations(dtype):
    def inputs(rng):
        return [rng.uniform(-1.2, 1.2, size=(6, 3)), rng.normal(size=(6, 3))]

    check_pair(0, inputs,
               lambda th, v: (jrot.euler_zyx_to_rot(th), jrot.euler_zyx_rate_to_world_omega_map(th),
                              jrot.skew(v), jrot.rot_to_euler_zyx(jrot.euler_zyx_to_rot(th)),
                              jax.vmap(lambda a, b: jax.jvp(
                                  jrot.euler_zyx_rate_to_world_omega_map, (a,), (b,))[1])(th, v)),
               lambda th, v: (trot.euler_zyx_to_rot(th), trot.euler_zyx_rate_to_world_omega_map(th),
                              trot.skew(v), trot.rot_to_euler_zyx(trot.euler_zyx_to_rot(th)),
                              trot.euler_zyx_rate_map_derivative(th, v)),
               dtype, what="rotations", **KIN_TOL[dtype])


def _qv(nq):
    def inputs(rng):
        return [rng.normal(size=(5, nq)) * 0.3, rng.normal(size=(5, nq)) * 0.5]
    return inputs


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_forward_kinematics(robot, dtype):
    jr, tr = jax_wb(robot)[1].robot, port_wb(robot)[1].robot
    check_pair(1, _qv(jr.nq),
               lambda q, v: (jax.vmap(lambda q_: jkin.forward_kinematics(jr, q_))(q),
                             jax.vmap(lambda q_, v_: jkin.forward_kinematics_vel(jr, q_, v_))(q, v)),
               lambda q, v: (tkin.forward_kinematics(tr, q),
                             tkin.forward_kinematics_vel(tr, q, v)),
               dtype, what=f"{robot} FK", **KIN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_jacobians_and_frames(robot, dtype):
    jr, tr = jax_wb(robot)[1].robot, port_wb(robot)[1].robot
    frames = ["foot_l_contact", "foot_r_contact_collision_p_1", "left_knee_joint"]

    def jax_fn(q, v):
        def one(q_, v_):
            fk = jkin.forward_kinematics(jr, q_)
            out = [jkin.all_body_jacobians(jr, fk)]
            for f in frames:
                out += [*jkin.frame_transform(jr, fk, f), jkin.frame_jacobian(jr, fk, f),
                        jkin.frame_velocity(jr, fk, f, v_)]
            return out
        return jax.vmap(one)(q, v)

    def port_fn(q, v):
        fk = tkin.forward_kinematics(tr, q)
        out = [tkin.all_body_jacobians(tr, fk)]
        for f in frames:
            out += [*tkin.frame_transform(tr, fk, f), tkin.frame_jacobian(tr, fk, f),
                    tkin.frame_velocity(tr, fk, f, v)]
        return out

    check_pair(2, _qv(jr.nq), jax_fn, port_fn, dtype, what=f"{robot} Jacobians",
               **KIN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_frame_bias_acceleration_is_the_jvp(dtype):
    """The port reads J̇ v off the bias recursion; JAX takes the jvp of
    q -> J(q) v along v (`ocp/wb_ocp.py:124-135`). Same quantity."""
    jr, tr = jax_wb("toy_biped")[1].robot, port_wb("toy_biped")[1].robot
    frames = ["foot_l_contact", "foot_r_contact"]

    def jax_fn(q, v):
        def one(q_, v_):
            def twist(qq, f):
                return jkin.frame_jacobian(jr, jkin.forward_kinematics(jr, qq), f) @ v_
            return [jax.jvp(lambda qq: twist(qq, f), (q_,), (v_,))[1] for f in frames]
        return jax.vmap(one)(q, v)

    def port_fn(q, v):
        fk, vb = tkin.forward_kinematics_vel(tr, q, v)
        return [tkin.frame_bias_acceleration(tr, fk, vb, f) for f in frames]

    tol = {"f64": dict(rtol=1e-10, atol=1e-11), "f32": dict(rtol=1e-4, atol=2e-5)}[dtype]
    check_pair(3, _qv(jr.nq), jax_fn, port_fn, dtype, what="J̇ v", **tol)
