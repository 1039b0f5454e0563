"""The port's MuJoCo physics loop against the JAX package's, on the CPU in
float64, on the port's MJCFs.

- `MujocoSimInterface`: both packages' interfaces on the same MJCF, reset,
  then a fixed `JointAction` in chunks of 50 physics steps: after each
  chunk every field of `get_state` equal to 1e-12, the contact flags and
  `n_resets` equal. Cases: a PD hold at the default posture under seeded
  target noise (humanoid23, toy_biped), and a collapse under zero torque
  that ends in an auto-reset (toy_biped).
- `run_mujoco_closed_loop` on toy_biped (N = 8, 0.2 s: 100 Hz MRT, 25 Hz
  MPC, 2 kHz physics), centroidal, synchronous and with
  `solve_latency = 0.012`: tick by tick, base positions and joint positions
  within MUJOCO_LOOP_TOL x max(1, max|ref|) (tests/test_torch_common.py),
  the solves' cost and g_norm too, the same step sizes, no reset in either.
  The whole-body loops are in tests/test_torch_mujoco_sim_wb.py.
- `use_pipeline=True` (a real solver thread): a smoke test of the port only.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    ASSETS,
    NO_BATCHING_FALLBACK,
    build_pair,
    check_mujoco_loop,
    mujoco_run,
)
from wb_humanoid_mpc_tpu.mpc import controller as jax_controller
from wb_humanoid_mpc_tpu.sim import mujoco_sim as jax_mujoco_sim
from wb_humanoid_mpc_tpu_torch.mpc import controller
from wb_humanoid_mpc_tpu_torch.sim import closed_loop, mujoco_sim

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

STATE_TOL = 1e-12   # MuJoCo is deterministic: the same actions give the same states


def _mjcf(robot):
    return str(ASSETS / robot / f"{robot}.xml")


def _sims(robot, **kw):
    return (jax_mujoco_sim.MujocoSimInterface(_mjcf(robot), **kw),
            mujoco_sim.MujocoSimInterface(_mjcf(robot), **kw))


def _assert_states_equal(got, ref, what):
    for field in ("time", "base_position", "base_quat_wxyz", "base_lin_vel_local",
                  "base_ang_vel_local", "joint_positions", "joint_velocities"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=0.0,
                                   atol=STATE_TOL, err_msg=f"{what} {field}")
    assert got.contact_flags == ref.contact_flags, what


@pytest.mark.parametrize("robot,case", [("humanoid23", "hold"), ("toy_biped", "hold"),
                                        ("toy_biped", "collapse")])
def test_sim_interface_matches_jax(robot, case):
    jsim, psim = _sims(robot)
    names = psim.joint_names
    assert names == jsim.joint_names
    n = psim.n_joints
    rng = np.random.default_rng(5)
    defaults = {jn: float(v) for jn, v in zip(names, rng.uniform(-0.2, 0.2, n))}
    jsim, psim = _sims(robot, initial_base_pos=(0.0, 0.0, 0.78321),
                       initial_joint_positions=defaults)
    z = np.zeros(n)
    if case == "hold":
        q_des = np.array([defaults[jn] for jn in names]) + rng.normal(size=n) * 0.05
        kw = dict(q_des=q_des, qd_des=z, kp=np.full(n, 300.0), kd=np.full(n, 5.0),
                  ff_effort=rng.normal(size=n))
        chunks = 2
    else:
        kw = dict(q_des=z, qd_des=z, kp=z, kd=z, ff_effort=z)
        chunks = 45
    for sim in (jsim, psim):
        sim.reset()
    for k in range(chunks):
        jsim.apply_action_and_step(jax_controller.JointAction(**kw), n_steps=50)
        psim.apply_action_and_step(controller.JointAction(**kw), n_steps=50)
        _assert_states_equal(psim.get_state(), jsim.get_state(), f"{robot} {case} chunk {k}")
        assert psim.n_resets == jsim.n_resets
    assert psim.n_resets == (1 if case == "collapse" else 0)


@pytest.fixture(scope="module")
def centroidal_pair():
    return build_pair("centroidal")


@pytest.mark.parametrize("mode", ["sync", "latency"])
def test_closed_loop_matches_jax(centroidal_pair, mode):
    check_mujoco_loop("centroidal", centroidal_pair, mode)


def test_closed_loop_pipeline_smoke():
    """`use_pipeline=True`: the solver thread publishes policies while the
    control loop steps the sim; the robot stays up and the thread stops.
    The loop is not paced to the wall clock, so until the first policy
    arrives each control tick waits 0.1 s (at most 4 s in all), as the
    reference's MRT waits for its first policy."""
    from wb_humanoid_mpc_tpu_torch.interface import build_centroidal_mpc, mpc_files

    mpc = build_centroidal_mpc(*mpc_files(ASSETS / "toy_biped", "centroidal"), n_nodes=8,
                               horizon=0.32, device="cpu", dtype=torch.float64)
    ctrl = controller.CentroidalMrtController(mpc.model, device="cpu", dtype=torch.float64)
    compute = ctrl.compute

    def waiting_compute(t, x, policy):
        if policy is None:
            time.sleep(0.1)
        return compute(t, x, policy)

    ctrl.compute = waiting_compute
    log = mujoco_run(mpc, mujoco_sim.MujocoSimInterface, ctrl,
                     closed_loop.run_mujoco_closed_loop, use_pipeline=True)
    assert log.n_resets == 0
    assert log.base_heights.min() > 0.75 * 0.78321
    assert len(log.solve_stats) > 0, "the pipeline produced no solve"
    assert all(np.isfinite(s.cost) for s in log.solve_stats)
    assert [t.name for t in threading.enumerate() if t.name == "mpc-solver"] == []
