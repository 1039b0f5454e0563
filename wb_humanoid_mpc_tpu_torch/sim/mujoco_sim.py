"""MuJoCo simulation interface (the `robot_runtime` equivalent).

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/sim/mujoco_sim.py`, itself
the reference's `MujocoSimInterface` (`MujocoSimInterface.{h,cpp}`: dt =
0.5 ms physics, per-step PD + feed-forward torques, `RobotState` extraction
with local-frame base velocities, auto-reset when base z < 0.2 m,
`MujocoSimInterface.cpp:313-388`). Physics advances through
`apply_action_and_step`: synchronously from `sim/closed_loop.py`, or on the
physics thread of `sim/sim_thread.py`. Contact flags are read from MuJoCo's
contact table. The physics is host MuJoCo in float64 numpy, as in JAX.

`mujoco` is imported when an interface is made, not when this module is, so
the package imports on a machine without it; the error a caller sees there
names the missing package. The port's robots carry their MJCFs beside their
URDFs: `assets/humanoid23/humanoid23.xml`, `assets/toy_biped/toy_biped.xml`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.mpc.controller import JointAction


@dataclasses.dataclass
class RobotState:
    """(reference `robot_model/RobotState.h:30-76`)"""
    time: float
    base_position: np.ndarray       # world
    base_quat_wxyz: np.ndarray      # local -> world
    base_lin_vel_local: np.ndarray
    base_ang_vel_local: np.ndarray
    joint_positions: np.ndarray     # full model order
    joint_velocities: np.ndarray
    contact_flags: list[bool]


class MujocoSimInterface:
    RESET_HEIGHT = 0.2  # reference MujocoSimInterface.cpp:372-388

    def __init__(self, mjcf_path: str, dt: float = 5e-4,
                 initial_base_pos=(0.0, 0.0, 0.793),
                 initial_joint_positions: dict[str, float] | None = None):
        import mujoco

        self._mj = mujoco
        self.model = mujoco.MjModel.from_xml_path(str(mjcf_path))
        self.model.opt.timestep = dt
        self.data = mujoco.MjData(self.model)
        self.dt = dt

        self.joint_names = [
            mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_JOINT, i)
            for i in range(self.model.njnt)
            if self.model.jnt_type[i] == mujoco.mjtJoint.mjJNT_HINGE
        ]
        self.n_joints = len(self.joint_names)
        # actuator i -> index of its joint in joint_names
        self._act_joint_idx = np.array([
            self.joint_names.index(mujoco.mj_id2name(
                self.model, mujoco.mjtObj.mjOBJ_JOINT, self.model.actuator_trnid[i, 0]))
            for i in range(self.model.nu)], dtype=int)
        # body ids of the ankle-roll (foot) links, for the contact flags
        self._foot_body_ids = [
            mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, f"{side}_ankle_roll_link")
            for side in ("left", "right")]
        self._init_base_pos = np.asarray(initial_base_pos, dtype=float)
        self._init_qj = np.zeros(self.n_joints)
        for k, v in (initial_joint_positions or {}).items():
            self._init_qj[self.joint_names.index(k)] = v
        self.n_resets = 0
        self.reset()

    # ---- lifecycle ----
    def reset(self) -> None:
        self._mj.mj_resetData(self.model, self.data)
        self.data.qpos[:3] = self._init_base_pos
        self.data.qpos[3:7] = [1.0, 0.0, 0.0, 0.0]
        self.data.qpos[7:] = self._init_qj
        self._mj.mj_forward(self.model, self.data)

    # ---- stepping ----
    def apply_action_and_step(self, action_full: JointAction, n_steps: int = 1) -> None:
        """PD + ff torque per actuator, then one physics step, `n_steps` times
        (reference `MujocoSimInterface.cpp:357-370`); stops early on a reset."""
        for _ in range(n_steps):
            tau = action_full.total_torque(self.data.qpos[7:], self.data.qvel[6:])
            self.data.ctrl[:] = tau[self._act_joint_idx]
            self._mj.mj_step(self.model, self.data)
            if self.data.qpos[2] < self.RESET_HEIGHT:
                self.n_resets += 1
                self.reset()
                break

    # ---- state extraction ----
    def get_state(self) -> RobotState:
        d = self.data
        quat = d.qpos[3:7].copy()
        R = np.zeros(9)
        self._mj.mju_quat2Mat(R, quat)
        R = R.reshape(3, 3)
        return RobotState(
            time=float(d.time),
            base_position=d.qpos[0:3].copy(),
            base_quat_wxyz=quat,
            base_lin_vel_local=R.T @ d.qvel[0:3],
            base_ang_vel_local=d.qvel[3:6].copy(),  # free joint: body-local already
            joint_positions=d.qpos[7:].copy(),
            joint_velocities=d.qvel[6:].copy(),
            contact_flags=self._foot_contacts(),
        )

    def _foot_contacts(self) -> list[bool]:
        """Per-foot contact flags from the MuJoCo contact table (the reference
        hard-codes these true, `MujocoSimInterface.cpp:313-318`)."""
        flags = [False, False]
        for c in range(self.data.ncon):
            con = self.data.contact[c]
            for g in (con.geom1, con.geom2):
                b = int(self.model.geom_bodyid[g])
                for i, fb in enumerate(self._foot_body_ids):
                    if b == fb:
                        flags[i] = True
        return flags
