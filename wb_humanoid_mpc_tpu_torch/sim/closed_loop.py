"""Single-process MuJoCo closed loop: MPC + MRT + physics.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/sim/closed_loop.py`, the
headless equivalent of the reference's `CentroidalMpcRobotSim` /
`WBMpcRobotSim` (`CentroidalMpcRobotSim.cpp:45-165`): physics at 2 kHz, the
MRT control loop at `mrt_frequency`, MPC solves at `mpc_frequency`, PD + ff
torques in between.

Three pacing modes:
- synchronous (default): solves interleave with control ticks; deterministic,
  the solver's latency is not charged to the timeline;
- `solve_latency > 0`: async MRT semantics through
  `mpc.async_runtime.SimulatedLatencyMpc`: a solve dispatched at sim time t
  activates at t + solve_latency, so control ticks go on with stale policies
  as with the reference's solver thread, reproducibly;
- `use_pipeline=True`: the real threaded pipeline (`MrtPipeline`): a solver
  thread consumes observations and publishes policies through seqlock
  buffers while the control loop steps the sim (wall clock, staleness not
  reproducible).

The solves run on the MPC interface's device (K1 and, whole-body, K2 on the
card); the controller must be on the same device. The observation (MuJoCo
state -> model chart -> MPC state) is computed on the CPU in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.mpc.controller import JointAction, robot_state_to_generalized
from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface


@dataclasses.dataclass
class ClosedLoopLog:
    times: np.ndarray
    base_positions: np.ndarray
    base_heights: np.ndarray
    joint_positions: np.ndarray
    solve_stats: list
    n_resets: int


def mpc_joint_indices(model, sim: MujocoSimInterface) -> np.ndarray:
    """Index in the sim's joint list of each joint of the MPC model."""
    return np.array([sim.joint_names.index(j) for j in model.robot.joint_names])


def observer(model, mpc_joint_idx: np.ndarray, observation_fn=None):
    """RobotState -> MPC state vector (float64 numpy), through the model's
    chart (reference `CentroidalMpcMrtJointController.cpp:101-121`)."""
    def observe(rs):
        q, v = robot_state_to_generalized(
            rs.base_position, rs.base_quat_wxyz, rs.base_lin_vel_local,
            rs.base_ang_vel_local, rs.joint_positions[mpc_joint_idx],
            rs.joint_velocities[mpc_joint_idx])
        if observation_fn is not None:
            return np.asarray(observation_fn(q, v))
        if hasattr(model, "state_from_generalized"):
            return model.state_from_generalized(q, v).numpy()
        return np.concatenate([q.numpy(), v.numpy()])

    return observe


def full_action(controller, action_mpc: JointAction, n_full: int,
                mpc_joint_idx: np.ndarray) -> JointAction:
    """The MPC joints' action, the other joints held at the controller's
    KP_FIXED / KD_FIXED around zero."""
    q_des, qd_des, ff = np.zeros(n_full), np.zeros(n_full), np.zeros(n_full)
    kp = np.full(n_full, controller.KP_FIXED)
    kd = np.full(n_full, controller.KD_FIXED)
    q_des[mpc_joint_idx] = action_mpc.q_des
    qd_des[mpc_joint_idx] = action_mpc.qd_des
    kp[mpc_joint_idx] = action_mpc.kp
    kd[mpc_joint_idx] = action_mpc.kd
    ff[mpc_joint_idx] = action_mpc.ff_effort
    return JointAction(q_des=q_des, qd_des=qd_des, kp=kp, kd=kd, ff_effort=ff)


def check_devices(runtime, controller) -> None:
    if controller.device != runtime.device:
        raise ValueError(f"the controller runs on {controller.device}, the MPC solves on "
                         f"{runtime.device}")


def run_mujoco_closed_loop(
    mpc_interface,                # CentroidalMpcInterface | WBMpcInterface
    controller,                   # CentroidalMrtController | WBMrtController
    sim: MujocoSimInterface,
    duration: float,
    mrt_frequency: float = 500.0,
    mpc_frequency: float = 80.0,
    command_fn=None,
    observation_fn=None,          # (q, v) float64 tensors -> MPC state vector
    solve_latency: float = 0.0,   # > 0: a policy becomes active solve_latency
                                  # sim-seconds after its observation
    use_pipeline: bool = False,   # real solver thread via MrtPipeline
) -> ClosedLoopLog:
    model = mpc_interface.model
    runtime = mpc_interface.runtime
    check_devices(runtime, controller)
    mpc_joint_idx = mpc_joint_indices(model, sim)
    observe = observer(model, mpc_joint_idx, observation_fn)

    dt_mrt = 1.0 / mrt_frequency
    steps_per_mrt = max(int(round(dt_mrt / sim.dt)), 1)
    solve_every = max(int(round(mrt_frequency / mpc_frequency)), 1)
    n_steps = int(round(duration * mrt_frequency))

    async_mpc = None
    pipeline = None
    if use_pipeline:
        from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline

        pipeline = MrtPipeline(runtime, nx=model.layout.state_dim, device=runtime.device)
        pipeline.start()
    elif solve_latency > 0.0:
        from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import SimulatedLatencyMpc

        async_mpc = SimulatedLatencyMpc(runtime, mpc_frequency, solve_latency)

    times, base_pos, heights, qjs = [], [], [], []
    stats = []
    try:
        for step in range(n_steps):
            rs = sim.get_state()
            t = rs.time
            x_obs = observe(rs)
            cmd = np.zeros(4) if command_fn is None else np.asarray(command_fn(t))
            if pipeline is not None:
                pipeline.push_observation(t, x_obs, cmd)
                policy = pipeline.get_policy()
                if pipeline.last_stats is not None and (
                        not stats or stats[-1] is not pipeline.last_stats):
                    stats.append(pipeline.last_stats)
            elif async_mpc is not None:
                policy = async_mpc.tick(t, x_obs, cmd)
                stats = async_mpc.stats
            else:
                if step % solve_every == 0:
                    stats.append(runtime.advance(t, x_obs, cmd))
                policy = runtime.policy

            action_mpc = controller.compute(t, x_obs, policy)
            sim.apply_action_and_step(full_action(controller, action_mpc, sim.n_joints,
                                                  mpc_joint_idx), n_steps=steps_per_mrt)
            times.append(t)
            base_pos.append(rs.base_position.copy())
            heights.append(rs.base_position[2])
            qjs.append(rs.joint_positions.copy())
    finally:
        if pipeline is not None:
            pipeline.stop()

    return ClosedLoopLog(
        times=np.asarray(times),
        base_positions=np.asarray(base_pos),
        base_heights=np.asarray(heights),
        joint_positions=np.asarray(qjs),
        solve_stats=stats,
        n_resets=sim.n_resets,
    )
