"""The port's sim / render / control threads (`sim/sim_thread.py`) and its
visualization layer (`viz/visualizer.py`), on the CPU.

- The physics thread on humanoid23's MJCF: the pacing gate, the seqlock
  state plane and the sim metrics; a `JointAction` written on the control
  side reaching the physics tick; the render thread's lifecycle (qpos
  snapshots without GL), as tests/test_sim_thread.py holds the JAX package's.
- `run_threaded_robot_sim` on toy_biped (N = 8, float64): 0.3 s at 250 Hz,
  faster than real time, each tick without a policy waiting 0.1 s: policies
  flow, the robot stays up, every thread it started has stopped.
- `render_scene` writes a PNG of more than 10 KB.
- `contacts_cop`, `contact_corner_forces` and `_skeleton_segments` against
  the JAX package's on the same inputs (1e-12).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, NO_BATCHING_FALLBACK, jax_wb, port_centroidal, port_wb
from wb_humanoid_mpc_tpu.viz import visualizer as jax_viz
from wb_humanoid_mpc_tpu_torch.mpc.controller import JointAction
from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface
from wb_humanoid_mpc_tpu_torch.sim.sim_thread import (
    MujocoRenderer,
    MujocoSimThread,
    run_threaded_robot_sim,
)
from wb_humanoid_mpc_tpu_torch.viz import visualizer

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

H23_MJCF = str(ASSETS / "humanoid23" / "humanoid23.xml")
VIZ_TOL = 1e-12


def _wait_until(cond, timeout=20.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.002)
    return False


def test_sim_thread_gate_and_metrics():
    sim = MujocoSimInterface(H23_MJCF)
    th = MujocoSimThread(sim, realtime=False)
    th.allowed_sim_time = 0.1
    th.start()
    try:
        assert _wait_until(lambda: th.read_state().time >= 0.1 - sim.dt)
        time.sleep(0.05)  # the thread now idles at the gate
        assert th.read_state().time <= 0.1 + 2 * sim.dt, "pacing gate overrun"
        assert th.metrics.ticks >= 190
        assert th.metrics.sim_fps > 0.0
        assert th.metrics.realtime_factor != 0.0
        th.allowed_sim_time = 0.15   # open the gate further: the thread resumes
        assert _wait_until(lambda: th.read_state().time >= 0.15 - sim.dt)
    finally:
        th.stop()
    assert th._thread is None


def test_sim_thread_action_flow():
    sim = MujocoSimInterface(H23_MJCF)
    th = MujocoSimThread(sim, realtime=False)
    n = sim.n_joints
    q_des = np.zeros(n)
    j = sim.joint_names.index("left_knee_joint")
    q_des[j] = 0.4
    th.write_action(JointAction(q_des=q_des, qd_des=np.zeros(n), kp=np.full(n, 200.0),
                                kd=np.full(n, 5.0), ff_effort=np.zeros(n)))
    th.allowed_sim_time = 0.15
    th.start()
    try:
        assert _wait_until(lambda: th.read_state().time >= 0.15 - sim.dt)
        st = th.read_state()
        assert st.joint_positions[j] > 0.05, "the commanded knee did not move toward q_des"
        assert isinstance(st.contact_flags[0], bool)
    finally:
        th.stop()


def test_renderer_thread_lifecycle():
    sim = MujocoSimInterface(H23_MJCF)
    th = MujocoSimThread(sim, realtime=False)
    th.allowed_sim_time = 0.5
    renderer = MujocoRenderer(th, fps=60.0)
    th.start()
    renderer.start()
    try:
        assert _wait_until(lambda: len(renderer.snapshots) >= 3, timeout=10.0)
    finally:
        renderer.stop()
        th.stop()
    assert renderer.snapshots[0].shape == (7 + sim.n_joints,)
    if renderer.gl_available:
        assert len(renderer.frames) > 0


def test_threaded_robot_sim():
    from wb_humanoid_mpc_tpu_torch.interface import build_centroidal_mpc, mpc_files
    from wb_humanoid_mpc_tpu_torch.mpc.controller import CentroidalMrtController

    mpc = build_centroidal_mpc(*mpc_files(ASSETS / "toy_biped", "centroidal"), n_nodes=8,
                               horizon=0.32, device="cpu", dtype=torch.float64)
    lay, x0 = mpc.model.layout, mpc.initial_state
    sim = MujocoSimInterface(
        str(ASSETS / "toy_biped" / "toy_biped.xml"),
        initial_joint_positions=dict(zip(mpc.model.robot.joint_names,
                                         map(float, lay.joint_angles(x0)))),
        initial_base_pos=(0.0, 0.0, float(lay.base_position(x0)[2])))
    ctrl = CentroidalMrtController(mpc.model, device="cpu", dtype=torch.float64)
    compute = ctrl.compute

    def waiting_compute(t, x, policy):
        # the loop is paced to the sim clock, not the wall clock: until the
        # first policy arrives each control tick waits 0.1 s (at most 7.5 s
        # in all), as the reference's MRT waits for its first policy
        if policy is None:
            time.sleep(0.1)
        return compute(t, x, policy)

    ctrl.compute = waiting_compute
    log, metrics, renderer = run_threaded_robot_sim(
        mpc, ctrl, sim, duration=0.3, mrt_frequency=250.0,
        command_fn=lambda t: np.zeros(4), realtime=False)
    assert renderer is None
    assert log.n_resets == 0, "the robot fell in the threaded sim"
    assert log.base_heights.min() > 0.75 * 0.78321
    assert len(log.solve_stats) > 0, "the solver thread produced no policy"
    assert metrics.ticks > 0
    alive = [t.name for t in threading.enumerate() if t.name in ("mujoco-sim", "mpc-solver")]
    assert alive == []


def test_render_scene(tmp_path):
    from wb_humanoid_mpc_tpu_torch.mpc.runtime import Policy

    _, m, _ = port_centroidal("humanoid23")
    nx, nu = m.layout.state_dim, m.layout.input_dim
    x = np.zeros(nx)
    x[8] = 0.78321
    x_target = x.copy()
    x_target[6] = 0.3
    xs = np.tile(x, (11, 1))
    xs[:, 6] = np.linspace(0.0, 0.3, 11)
    u = np.zeros(nu)
    u[2] = u[8] = m.robot.total_mass * m.robot.gravity / 2.0
    u[3] = 2.0  # a small moment shifts the CoP
    policy = Policy(t0=0.0, dt=0.1, xs=xs, us=np.tile(u, (10, 1)),
                    contact_flags=np.ones((11, 2)))
    out = visualizer.render_scene(m, x, policy=policy, x_target=x_target, u_current=u,
                                  out_path=str(tmp_path / "scene.png"))
    assert os.path.exists(out) and os.path.getsize(out) > 10_000


@pytest.mark.parametrize("seed", range(3))
def test_contacts_cop_and_corner_forces_match_jax(seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(2, 3))
    w = rng.normal(size=(2, 6))
    w[:, 2] = rng.uniform(10.0, 200.0, 2)
    if seed == 2:
        w[1, 2] = 0.0   # one unloaded foot
    np.testing.assert_allclose(visualizer.contacts_cop(p, w), jax_viz.contacts_cop(p, w),
                               rtol=0.0, atol=VIZ_TOL)
    assert visualizer.contacts_cop(p, np.zeros((2, 6))) is None
    corners = np.array([[-0.05, -0.03, 0.0], [0.12, -0.03, 0.0], [0.12, 0.03, 0.0],
                        [-0.05, 0.03, 0.0]])
    np.testing.assert_allclose(visualizer.contact_corner_forces(w[0], corners),
                               jax_viz.contact_corner_forces(w[0], corners), rtol=0.0,
                               atol=VIZ_TOL)


@pytest.mark.parametrize("robot", ["humanoid23", "toy_biped"])
def test_skeleton_segments_match_jax(robot):
    _, jm, _ = jax_wb(robot)
    _, pm, _ = port_wb(robot)
    rng = np.random.default_rng(4)
    q = rng.normal(size=pm.robot.nq) * 0.4
    got = visualizer._skeleton_segments(pm.robot, q)
    ref = jax_viz._skeleton_segments(jm.robot, q)
    assert got.shape == (pm.robot.n_joints, 2, 3)
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=VIZ_TOL)
