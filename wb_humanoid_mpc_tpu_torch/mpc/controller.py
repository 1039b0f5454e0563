"""MRT joint controllers: MPC policy -> PD + feed-forward joint actions.

PyTorch counterpart of `wb_humanoid_mpc_tpu/mpc/controller.py`, itself the
reference's MRT controllers:
- centroidal: `CentroidalMpcMrtJointController.cpp:101-196`: observation
  conversion (quat -> euler-ZYX, momentum map), policy evaluation at t + 5 ms,
  contact-consistent inverse-dynamics feed-forward with error-feedback desired
  joint accelerations, kp 1200 / kd 10 on the MPC joints, kp 100 / kd 1 on
  fixed joints, a weight-compensating fallback before the first policy;
- whole-body: `WBMpcMrtJointController.cpp:141-192`: feed-forward torques
  from `computeJointTorques(policyState, policyInput)` directly.

Where JAX jits the feed-forward, the port runs it eagerly on the
controller's device. On the card the controller owns a CUDA stream and does
all its device work on it: the solver thread queues thousands of launches a
solve on its own current stream, and a control tick must not wait behind
them.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device
from wb_humanoid_mpc_tpu_torch.utils.rotations import (
    quat_to_rot,
    rot_to_euler_zyx,
    world_omega_to_euler_zyx_rate_map,
)


@dataclasses.dataclass
class JointAction:
    """Per-joint PD + ff command (reference `RobotJointAction.h:8-16`)."""
    q_des: np.ndarray
    qd_des: np.ndarray
    kp: np.ndarray
    kd: np.ndarray
    ff_effort: np.ndarray

    def total_torque(self, q: np.ndarray, qd: np.ndarray) -> np.ndarray:
        """(reference `getTotalFeedbackTorque`)"""
        return self.kp * (self.q_des - q) + self.kd * (self.qd_des - qd) + self.ff_effort


def robot_state_to_generalized(base_pos, base_quat_wxyz, v_lin_local, omega_local,
                               q_joints, qd_joints):
    """MuJoCo / hardware state -> the model's chart (q, v) (reference
    `CentroidalMpcMrtJointController.cpp:101-121` updateMpcState). Takes
    tensors or array-likes (float64); returns tensors."""
    base_pos, base_quat_wxyz, v_lin_local, omega_local, q_joints, qd_joints = (
        torch.as_tensor(a, dtype=torch.float64) if not isinstance(a, torch.Tensor) else a
        for a in (base_pos, base_quat_wxyz, v_lin_local, omega_local, q_joints, qd_joints))
    R = quat_to_rot(base_quat_wxyz)
    euler = rot_to_euler_zyx(R)
    v_world = R @ v_lin_local
    omega_world = R @ omega_local
    euler_rates = world_omega_to_euler_zyx_rate_map(euler) @ omega_world
    q = torch.cat([base_pos, euler, q_joints])
    v = torch.cat([v_world, euler_rates, qd_joints])
    return q, v


class _MrtController:
    """What both controllers share: the device, the controller's own CUDA
    stream, the fallback input and the policy lookup."""

    KP = 1200.0
    KD = 10.0
    KP_FIXED = 100.0
    KD_FIXED = 1.0

    def __init__(self, model, policy_lead_time: float, device, dtype):
        self.model = model
        self.lead = policy_lead_time
        self.device = resolve_device(device)
        self.dtype = dtype
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with self._on_stream():
            self._u_comp = weight_comp_input(
                model.robot.total_mass, model.robot.gravity,
                torch.ones(2, dtype=dtype, device=self.device), model.layout.input_dim)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        # on the controller's stream: waits for this stream's work only
        return t.double().cpu().numpy()

    def _fallback(self, tau: np.ndarray) -> JointAction:
        n = self.model.layout.n_joints
        return JointAction(q_des=np.zeros(n), qd_des=np.zeros(n), kp=np.zeros(n),
                           kd=np.zeros(n), ff_effort=tau)


class CentroidalMrtController(_MrtController):
    """kp/kd and the inverse-dynamics feedback gains of the reference controller."""

    ID_KP = 100.0   # error feedback on the desired joint accelerations
    ID_KD = 10.0

    def __init__(self, model, policy_lead_time: float = 0.005, *, device="cuda",
                 dtype=torch.float32):
        super().__init__(model, policy_lead_time, device, dtype)

    def ff_torques(self, x_obs: torch.Tensor, x_pol: torch.Tensor, u_pol: torch.Tensor):
        """Contact-consistent inverse-dynamics feed-forward at the observed
        state, tracking the policy's joint angles and velocities."""
        model, lay, robot = self.model, self.model.layout, self.model.robot
        q = lay.generalized_coordinates(x_obs)
        v = model.generalized_velocity(x_obs, torch.zeros_like(lay.joint_angles(x_obs)))
        q_des = lay.joint_angles(x_pol)
        qd_des = lay.joint_input(u_pol)
        qdd_des = (self.ID_KP * (q_des - lay.joint_angles(x_obs))
                   + self.ID_KD * (qd_des - v[..., 6:]))
        mn = dyn.mass_and_nle(robot, q, v)
        J_c = torch.stack([kin.frame_jacobian(robot, mn.fk, f) for f in model.contact_frames],
                          dim=-3)
        W = lay.contact_wrenches(u_pol)
        return dyn.joint_torques(robot, mn.M, mn.nle, qdd_des, J_c, W)

    def compute(self, t: float, x_obs: np.ndarray, policy) -> JointAction:
        lay = self.model.layout
        n = lay.n_joints
        with self._on_stream():
            x = self._tensor(x_obs)
            if policy is None:
                # weight-compensating fallback (reference :173-196)
                return self._fallback(self._numpy(self.ff_torques(x, x, self._u_comp)))
            x_pol, u_pol, _ = policy.evaluate(t + self.lead)
            xp, up = self._tensor(x_pol), self._tensor(u_pol)
            tau = self._numpy(self.ff_torques(x, xp, up))
        return JointAction(q_des=np.asarray(lay.joint_angles(np.asarray(x_pol)), dtype=float),
                           qd_des=np.asarray(lay.joint_input(np.asarray(u_pol)), dtype=float),
                           kp=np.full(n, self.KP), kd=np.full(n, self.KD), ff_effort=tau)


class WBMrtController(_MrtController):
    def __init__(self, model, policy_lead_time: float = 0.005, *, device="cuda",
                 dtype=torch.float32):
        super().__init__(model, policy_lead_time, device, dtype)

    def compute(self, t: float, x_obs: np.ndarray, policy) -> JointAction:
        lay = self.model.layout
        n = lay.n_joints
        with self._on_stream():
            if policy is None:
                tau = self.model.joint_torques(self._tensor(x_obs), self._u_comp)
                return self._fallback(self._numpy(tau))
            x_pol, u_pol, _ = policy.evaluate(t + self.lead)
            tau = self._numpy(self.model.joint_torques(self._tensor(x_pol), self._tensor(u_pol)))
        return JointAction(q_des=np.asarray(lay.joint_angles(np.asarray(x_pol)), dtype=float),
                           qd_des=np.asarray(lay.joint_velocities(np.asarray(x_pol)), dtype=float),
                           kp=np.full(n, self.KP), kd=np.full(n, self.KD), ff_effort=tau)
