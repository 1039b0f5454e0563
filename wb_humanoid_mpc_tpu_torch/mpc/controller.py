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

Where JAX jits the feed-forward (`jax.jit(model.joint_torques)`, the
centroidal `ff_torques`), the port captures it into one CUDA graph per
controller on the card (`utils/graphs.py::GraphedFunction`, at the first
`compute`; the weight-compensating fallback replays the same graph on other
inputs) and replays it every tick; `graphs=False` computes it eagerly, op
by op. On the card the controller owns a CUDA stream and does all its
device work on it: the solver thread queues a solve's work on its
own current stream, and a control tick must not wait behind it. A graphed
tick copies its inputs into pinned host buffers, then (`non_blocking`) into
the graph's static inputs, replays the graph, copies the torques into a
pinned buffer and waits for its stream; the pinned buffers are reused only
after that wait.
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
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction
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


@dataclasses.dataclass
class _Staging:
    """Host buffers of a graphed tick: its inputs and, once known, the torques."""
    inputs: list
    out: torch.Tensor | None = None


class _MrtController:
    """What both controllers share: the device, the controller's own CUDA
    stream, the fallback input, the feed-forward function `feed_forward`
    and, where it is graphed, its `graph`."""

    KP = 1200.0
    KD = 10.0
    KP_FIXED = 100.0
    KD_FIXED = 1.0

    def __init__(self, model, policy_lead_time: float, device, dtype, graphs, feed_forward,
                 name: str):
        self.model = model
        self.lead = policy_lead_time
        self.device = resolve_device(device)
        self.dtype = dtype
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # float64 host values of the dtype's weight-compensating input
        self._u_comp = weight_comp_input(
            model.robot.total_mass, model.robot.gravity, torch.ones(2, dtype=dtype),
            model.layout.input_dim).double().numpy()
        self.feed_forward = feed_forward
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.graph = (GraphedFunction(feed_forward, self.device, name, stream=self.stream)
                      if graphs else None)
        self._staging: _Staging | None = None

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    def _torques(self, *arrays) -> np.ndarray:
        """feed_forward at host arrays, as float64 host values: on the card
        one replay of its graph, else eagerly (both on the controller's
        stream, waiting for its work only)."""
        arrays = [np.asarray(a, dtype=np.float64) for a in arrays]
        if self.graph is None:
            with self._on_stream():
                return self.feed_forward(*(self._tensor(a) for a in arrays)).double().cpu().numpy()
        pin = self.device.type == "cuda"
        if self._staging is None:
            self._staging = _Staging([torch.empty(a.shape, dtype=self.dtype, pin_memory=pin)
                                      for a in arrays])
        stage = self._staging
        for buf, a in zip(stage.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        with self._on_stream():
            tau = self.graph.run(*stage.inputs, non_blocking=True)
            if stage.out is None:
                stage.out = torch.empty(tau.shape, dtype=tau.dtype, pin_memory=pin)
            stage.out.copy_(tau, non_blocking=True)
            if self.stream is not None:
                self.stream.synchronize()
        return stage.out.numpy().astype(np.float64)

    def _fallback(self, tau: np.ndarray) -> JointAction:
        n = self.model.layout.n_joints
        return JointAction(q_des=np.zeros(n), qd_des=np.zeros(n), kp=np.zeros(n),
                           kd=np.zeros(n), ff_effort=tau)


class CentroidalMrtController(_MrtController):
    """kp/kd and the inverse-dynamics feedback gains of the reference
    controller. `graphs`: None (the default) graphs the feed-forward
    `ff_torques` on a CUDA device and runs it eagerly on the CPU; True
    graphs it (raises on the CPU); False runs it eagerly."""

    ID_KP = 100.0   # error feedback on the desired joint accelerations
    ID_KD = 10.0

    def __init__(self, model, policy_lead_time: float = 0.005, *, device="cuda",
                 dtype=torch.float32, graphs: bool | None = None):
        super().__init__(model, policy_lead_time, device, dtype, graphs, self.ff_torques,
                         "the centroidal MRT controller's feed-forward")

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
        if policy is None:
            # weight-compensating fallback (reference :173-196)
            return self._fallback(self._torques(x_obs, x_obs, self._u_comp))
        x_pol, u_pol, _ = policy.evaluate(t + self.lead)
        tau = self._torques(x_obs, x_pol, u_pol)
        return JointAction(q_des=np.asarray(lay.joint_angles(np.asarray(x_pol)), dtype=float),
                           qd_des=np.asarray(lay.joint_input(np.asarray(u_pol)), dtype=float),
                           kp=np.full(n, self.KP), kd=np.full(n, self.KD), ff_effort=tau)


class WBMrtController(_MrtController):
    """Feed-forward torques `model.joint_torques` at the policy's state and
    input; `graphs` as for `CentroidalMrtController`."""

    def __init__(self, model, policy_lead_time: float = 0.005, *, device="cuda",
                 dtype=torch.float32, graphs: bool | None = None):
        super().__init__(model, policy_lead_time, device, dtype, graphs, model.joint_torques,
                         "the whole-body MRT controller's feed-forward")

    def compute(self, t: float, x_obs: np.ndarray, policy) -> JointAction:
        lay = self.model.layout
        n = lay.n_joints
        if policy is None:
            return self._fallback(self._torques(x_obs, self._u_comp))
        x_pol, u_pol, _ = policy.evaluate(t + self.lead)
        tau = self._torques(x_pol, u_pol)
        return JointAction(q_des=np.asarray(lay.joint_angles(np.asarray(x_pol)), dtype=float),
                           qd_des=np.asarray(lay.joint_velocities(np.asarray(x_pol)), dtype=float),
                           kp=np.full(n, self.KP), kd=np.full(n, self.KD), ff_effort=tau)
