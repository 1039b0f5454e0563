"""Whole-body dynamics model (flow map), batched over leading dims.

PyTorch counterpart of `wb_humanoid_mpc_tpu/models/wb_model.py`.

State  x = [q_base(6), q_joints(n), v_base(6), v_joints(n)]
Input  u = [W_l(6), W_r(6), qdd_joints(n)]

Flow map: x_dot = [v ; a(q, v, u)] where the base acceleration solves the
6 base rows of M(q) a + nle(q, v) = J_c^T W given the commanded joint
accelerations.
"""

from __future__ import annotations

import dataclasses

import torch

from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.models.layout import WBLayout
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel


@dataclasses.dataclass(frozen=True)
class WholeBodyModel:
    robot: RobotModel
    layout: WBLayout
    contact_frames: tuple[str, ...]

    @property
    def state_dim(self) -> int:
        return self.layout.state_dim

    @property
    def input_dim(self) -> int:
        return self.layout.input_dim

    def _contact_jacobians(self, fk):
        return torch.stack([kin.frame_jacobian(self.robot, fk, f) for f in self.contact_frames],
                           dim=-3)

    def _accelerations(self, fk, vb, v, u):
        lay = self.layout
        J = kin.all_body_jacobians(self.robot, fk)
        M6, nle6 = dyn.base_rows_mass_nle(self.robot, fk, vb, J)
        a = dyn.generalized_accelerations_rows(M6, nle6, dyn.spd_factor_unrolled(M6[..., :, :6]),
                                               lay.joint_input(u), self._contact_jacobians(fk),
                                               lay.contact_wrenches(u))
        return torch.cat([v, a], dim=-1)

    def flow_map(self, t, x, u):
        """x_dot for x [..., nx], u [..., nu] (t unused: time-invariant)."""
        q = self.layout.generalized_coordinates(x)
        v = self.layout.generalized_velocities(x)
        fk, vb = kin.forward_kinematics_vel(self.robot, q, v)
        return self._accelerations(fk, vb, v, u)

    def flow_map_batch(self, ts, xs, us, backend: str = "auto"):
        """Flow map over a leading batch dim (ts [B], xs [B,nx], us [B,nu]).
        Backend "cuda" (and "auto" on CUDA tensors): one launch of K2's flow
        variant, `ops/fkvel.py::flow_map_cuda`, from (xs, us) to x_dot.
        Backend "plain" (and "auto" on CPU tensors): its plain version, the
        batched FK + velocity/bias pass of `ops/fkvel.py` then
        `_accelerations`. Used for the RK4 stages and line-search rollouts,
        which are not differentiated."""
        from wb_humanoid_mpc_tpu_torch.ops import fkvel

        if backend == "auto":
            backend = "cuda" if xs.is_cuda else "plain"
        if backend == "cuda":
            return fkvel.flow_map_cuda(self, xs, us)
        q = self.layout.generalized_coordinates(xs)
        v = self.layout.generalized_velocities(xs)
        fk, vb = fkvel.fkvel_batch(self.robot, q, v, backend=backend)
        return self._accelerations(fk, vb, v, us)

    def joint_torques(self, x, u):
        """Per-node feed-forward torques from the full M and nle."""
        lay = self.layout
        q = lay.generalized_coordinates(x)
        v = lay.generalized_velocities(x)
        fk, vb = kin.forward_kinematics_vel(self.robot, q, v)
        J = kin.all_body_jacobians(self.robot, fk)
        M = dyn.mass_matrix_from(self.robot, fk, J)
        nle = dyn.nle_newton_euler(self.robot, fk, vb, J)
        return dyn.joint_torques(self.robot, M, nle, lay.joint_input(u),
                                 self._contact_jacobians(fk), lay.contact_wrenches(u))

    def initial_state(self, base_pose, joint_angles):
        """x = [base_pose, joint_angles] with zero velocities."""
        q = torch.cat([torch.as_tensor(base_pose), torch.as_tensor(joint_angles)])
        return self.layout.assemble(q, torch.zeros_like(q))
