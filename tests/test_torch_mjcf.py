"""The port's MuJoCo models (`assets/<robot>/<robot>.xml`) against their URDFs.

Both MJCFs load; their hinges are the URDF's revolute joints in URDF order,
with the URDF's limits and one motor each whose control range is the
joint's effort limit; at 3 seeded random configurations per robot the
committed file's joint-space mass matrix (`mj_fullM`, its armature taken
off the diagonal) equals that of `tests/_mj_oracle.py::build_mjcf` for the
JAX package's `RobotModel` of the same URDF, within 1e-10 relative to its
largest entry; at the default state (reference base height and joint
angles) the corners of each foot's collision box are the model's contact
polygon corners (1e-9 m) and lie within 2 mm of the floor; and, in a MuJoCo
free fall (RK4, 1 ms, constraints off), the port's kinetic and potential
energy equal MuJoCo's (1e-9 relative) and their sum, with the armature's
share, is conserved to 1e-6 relative, as in tests/test_dynamics_vs_mujoco.py.
"""

from __future__ import annotations

import mujoco
import numpy as np
import pytest
import torch

from tests._mj_oracle import build_mjcf
from wb_humanoid_mpc_tpu.models.robot.urdf import load_robot_model as jax_load_robot_model
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import full_joint_list, load_robot_model
from wb_humanoid_mpc_tpu_torch.mpc.controller import robot_state_to_generalized

torch.set_num_threads(1)

ROBOTS = ["humanoid23", "toy_biped"]
MASS_TOL = 1e-10     # x max |M|
FEET_TOL = 2e-3      # m, the contact polygon above or below the floor
CORNER_TOL = 1e-9    # m, MuJoCo's foot box against the model's polygon
ENERGY_TOL = 1e-6    # x max(1, |E0|): conservation over 50 RK4 steps
ENERGY_MATCH = 1e-9  # x max(1, |E|): the port's energies against MuJoCo's


def _files(robot):
    d = interface.ASSETS / robot
    return str(d / f"{robot}.urdf"), str(d / f"{robot}.xml")


@pytest.fixture(scope="module", params=ROBOTS)
def robot(request):
    urdf, mjcf = _files(request.param)
    m = mujoco.MjModel.from_xml_path(mjcf)
    return request.param, urdf, m


def _hinges(m):
    return [mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, i) for i in range(m.njnt)
            if m.jnt_type[i] == mujoco.mjtJoint.mjJNT_HINGE]


def test_mjcf_loads(robot):
    name, urdf, m = robot
    assert m.jnt_type[0] == mujoco.mjtJoint.mjJNT_FREE
    assert m.nq == 7 + m.nu and m.nv == 6 + m.nu
    assert m.opt.timestep == 5e-4


def test_mjcf_joints_and_actuators(robot):
    import xml.etree.ElementTree as ET

    name, urdf, m = robot
    hinges = _hinges(m)
    assert hinges == full_joint_list(urdf)
    limits = {j.attrib["name"]: j.find("limit").attrib
              for j in ET.parse(urdf).getroot().findall("joint") if j.attrib["type"] == "revolute"}
    assert list(limits) == hinges
    assert m.nu == len(hinges)
    for i, jn in enumerate(hinges):
        jid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, jn)
        assert m.actuator_trnid[i, 0] == jid
        np.testing.assert_array_equal(m.jnt_range[jid], [float(limits[jn]["lower"]),
                                                         float(limits[jn]["upper"])])
        eff = float(limits[jn]["effort"])
        np.testing.assert_array_equal(m.actuator_ctrlrange[i], [-eff, eff])
        assert m.dof_damping[m.jnt_dofadr[jid]] == 0.0


def test_mjcf_mass_matrix_matches_oracle(robot):
    name, urdf, m = robot
    oracle = mujoco.MjModel.from_xml_string(build_mjcf(jax_load_robot_model(urdf, None, name)))
    d, do = mujoco.MjData(m), mujoco.MjData(oracle)
    rng = np.random.default_rng(3)
    for _ in range(3):
        qpos = np.zeros(m.nq)
        qpos[:3] = rng.standard_normal(3)
        quat = rng.standard_normal(4)
        qpos[3:7] = quat / np.linalg.norm(quat)
        qpos[7:] = rng.uniform(-1.0, 1.0, m.nq - 7)
        M, Mo = np.zeros((m.nv, m.nv)), np.zeros((m.nv, m.nv))
        d.qpos[:] = qpos
        mujoco.mj_forward(m, d)
        mujoco.mj_fullM(m, d, M)
        do.qpos[:] = qpos
        mujoco.mj_forward(oracle, do)
        mujoco.mj_fullM(oracle, do, Mo)
        M -= np.diag(m.dof_armature)
        err = np.abs(M - Mo).max()
        assert err <= MASS_TOL * np.abs(Mo).max(), f"{name}: |dM| {err:.3e}"


def test_feet_on_the_floor_at_the_default_state(robot):
    name, urdf, m = robot
    mpc = interface.build_wb_mpc(*interface.mpc_files(interface.ASSETS / name, "wb"),
                                 n_nodes=2, device="cpu", dtype=torch.float64)
    lay, model = mpc.model.layout, mpc.model
    x0 = torch.as_tensor(mpc.initial_state)
    q = lay.generalized_coordinates(x0)
    assert float(q[2]) == 0.78321
    d = mujoco.MjData(m)
    d.qpos[:3] = q[:3].numpy()
    d.qpos[3:7] = [1.0, 0.0, 0.0, 0.0]
    hinges = _hinges(m)
    for jn, v in zip(model.robot.joint_names, lay.joint_angles(x0).tolist()):
        d.qpos[7 + hinges.index(jn)] = v
    mujoco.mj_forward(m, d)
    fk = kin.forward_kinematics(model.robot, q)
    for contact in model.contact_frames:
        g = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, f"{contact}_box")
        R, c, h = d.geom_xmat[g].reshape(3, 3), d.geom_xpos[g], m.geom_size[g]
        box = [c + R @ (np.array([sx, sy, -1.0]) * h) for sx, sy in ((-1, -1), (1, -1), (1, 1),
                                                                      (-1, 1))]
        poly = [kin.frame_transform(model.robot, fk, f"{contact}_p_{i}")[1].numpy()
                for i in range(4)]
        np.testing.assert_allclose(box, poly, rtol=0.0, atol=CORNER_TOL)
        z = np.array(poly)[:, 2]
        assert np.abs(z).max() <= FEET_TOL, f"{name} {contact}: corner heights {z}"


def _energies(rm, m, d):
    """(port kinetic + armature share, port potential, MuJoCo's kinetic,
    MuJoCo's potential) at MuJoCo's state."""
    R = np.zeros(9)
    mujoco.mju_quat2Mat(R, d.qpos[3:7])
    q, v = robot_state_to_generalized(d.qpos[:3], d.qpos[3:7], R.reshape(3, 3).T @ d.qvel[:3],
                                      d.qvel[3:6], d.qpos[7:], d.qvel[6:])
    arm = 0.5 * float(np.sum(m.dof_armature * d.qvel ** 2))
    mujoco.mj_energyPos(m, d)
    mujoco.mj_energyVel(m, d)
    return (float(dyn.kinetic_energy(rm, q, v)) + arm, float(dyn.potential_energy(rm, q)),
            float(d.energy[1]), float(d.energy[0]))


def test_energy_conserved_in_a_mujoco_free_fall(robot):
    name, urdf, m = robot
    rm = load_robot_model(urdf, None, name)
    m.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
    m.opt.timestep = 1e-3
    m.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONSTRAINT
    d = mujoco.MjData(m)
    rng = np.random.default_rng(8)
    d.qpos[:3] = [0.0, 0.0, 2.0]
    quat = rng.standard_normal(4)
    d.qpos[3:7] = quat / np.linalg.norm(quat)
    d.qpos[7:] = rng.standard_normal(m.nq - 7) * 0.5
    d.qvel[:] = rng.standard_normal(m.nv) * 0.3
    mujoco.mj_forward(m, d)
    energies = []
    for k in range(51):
        if k % 10 == 0:
            ke, pe, ke_mj, pe_mj = _energies(rm, m, d)
            for got, ref, what in ((ke, ke_mj, "kinetic"), (pe, pe_mj, "potential")):
                assert abs(got - ref) <= ENERGY_MATCH * max(1.0, abs(ref)), (name, k, what)
            energies.append(ke + pe)
        mujoco.mj_step(m, d)
    e = np.array(energies)
    assert np.abs(e - e[0]).max() <= ENERGY_TOL * max(1.0, abs(e[0])), e
