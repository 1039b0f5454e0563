"""Centroidal dynamics MPC model (flow map + helpers), batched over leading dims.

PyTorch counterpart of `wb_humanoid_mpc_tpu/models/centroidal_model.py`.

State  x = [h(6) normalized centroidal momentum, q_base(6), q_joints(n)]
Input  u = [W_l(6), W_r(6), qd_joints(n)]   (wrenches world-frame at contact frames)

Flow map (FullCentroidalDynamics, `centroidalModelType 0`):
    h_dot   = (1/m) * [ sum_i f_i + m*g_vec ;
                        sum_i ((p_ci - p_com) x f_i + tau_i) ]
    qb_dot  = A_b(q)^-1 (m*h - A_j(q) qd_j)     (centroidal momentum matrix split)
    qj_dot  = u_joints

The base solve is the closed-form block back-substitution of the JAX module
(`_inv3`, `solve_centroidal_base`), written out elementwise so that it rounds
as JAX does and `torch.func` differentiates it without a linear-algebra call.
"""

from __future__ import annotations

import dataclasses

import torch

from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.models.layout import CentroidalLayout
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel
from wb_humanoid_mpc_tpu_torch.utils.rotations import cross


def _inv3(M):
    """Closed-form 3x3 inverse (adjugate / det) of M [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + d * B + g * C
    adj = torch.stack([torch.stack([A, B, C], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def solve_centroidal_base(A_b, rhs):
    """A_b^-1 rhs for the CMM base block A_b [..., 6, 6], rhs [..., 6].

    A pure base translation moves every body uniformly, so the angular
    momentum about the COM is exactly zero: A_b = [[m I3, A12], [0, A22]].
    Block back-substitution with a closed-form 3x3 inverse.
    """
    w = (_inv3(A_b[..., 3:, 3:]) @ rhs[..., 3:, None])[..., 0]
    v = (rhs[..., :3] - (A_b[..., :3, 3:] @ w[..., None])[..., 0]) / A_b[..., 0:1, 0]
    return torch.cat([v, w], dim=-1)


@dataclasses.dataclass(frozen=True)
class CentroidalModel:
    robot: RobotModel
    layout: CentroidalLayout
    contact_frames: tuple[str, ...]
    # centroidalModelType 1 = Single Rigid Body Dynamics: the centroidal
    # momentum matrix is evaluated at a fixed nominal joint posture and the
    # joint-velocity momentum contribution is dropped.
    srbm: bool = False
    nominal_joint_angles: tuple = ()
    # the nominal joint angles as tensors, one per (device, dtype)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def state_dim(self) -> int:
        return self.layout.state_dim

    @property
    def input_dim(self) -> int:
        return self.layout.input_dim

    def _nominal(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        hit = self._cache.get(key)
        if hit is None:
            hit = torch.tensor(self.nominal_joint_angles, dtype=like.dtype, device=like.device)
            self._cache[key] = hit
        return hit

    def _momentum_matrix(self, q, fk=None):
        """A(q) [..., 6, nq] for the full model (from `fk`, the kinematics at
        q, when the caller has it); the SRBD variant evaluates it at the
        nominal joints and zeros the joint columns."""
        if not self.srbm:
            if fk is None:
                fk = kin.forward_kinematics(self.robot, q)
            return dyn.centroidal_momentum_matrix_from(self.robot, fk)
        q_nom = torch.cat([q[..., :6], self._nominal(q).expand(*q.shape[:-1], -1)], dim=-1)
        A = dyn.centroidal_momentum_matrix(self.robot, q_nom)
        return torch.cat([A[..., :6], torch.zeros_like(A[..., 6:])], dim=-1)

    def _base_velocity(self, A, h, qd_j):
        """qb_dot from A_b qb_dot + A_j qd_j = m h."""
        rhs = self.robot.total_mass * h - (A[..., 6:] @ qd_j[..., None])[..., 0]
        return solve_centroidal_base(A[..., :6], rhs)

    def flow_map(self, t, x, u):
        """dx/dt for x [..., nx], u [..., nu] (t unused: time-invariant)."""
        lay = self.layout
        robot = self.robot
        m_total = robot.total_mass

        h = lay.momentum(x)
        q = lay.generalized_coordinates(x)
        qd_j = lay.joint_input(u)

        fk = kin.forward_kinematics(robot, q)
        p_com = dyn.com_from_fk(robot, fk)

        # momentum rate from contact wrenches + gravity
        f_sum = tau_sum = None
        for i, frame in enumerate(self.contact_frames):
            _, p_ci = kin.frame_transform(robot, fk, frame)
            f_i = lay.contact_force(u, i)
            tau_i = lay.contact_torque(u, i)
            f_sum = f_i if f_sum is None else f_sum + f_i
            tau_i = cross(p_ci - p_com, f_i) + tau_i
            tau_sum = tau_i if tau_sum is None else tau_sum + tau_i
        lin = f_sum / m_total
        lin = torch.cat([lin[..., :2], lin[..., 2:] - robot.gravity], dim=-1)
        h_dot = torch.cat([lin, tau_sum / m_total], dim=-1)

        qb_dot = self._base_velocity(self._momentum_matrix(q, fk), h, qd_j)
        return torch.cat([h_dot, qb_dot, qd_j], dim=-1)

    def initial_state(self, base_pose, joint_angles):
        base_pose = torch.as_tensor(base_pose)
        joint_angles = torch.as_tensor(joint_angles, dtype=base_pose.dtype,
                                       device=base_pose.device)
        return self.layout.assemble(torch.zeros_like(base_pose), base_pose, joint_angles)

    def state_from_generalized(self, q, v):
        """(q, v) of the rigid-body chart -> centroidal state (h = A v / mass)."""
        return torch.cat([dyn.normalized_centroidal_momentum(self.robot, q, v), q], dim=-1)

    def generalized_velocity(self, x, qd_j, fk=None):
        """Full generalized velocity from the state and the joint velocity
        input (`fk`: the kinematics at x's q, when the caller has it)."""
        lay = self.layout
        A = self._momentum_matrix(lay.generalized_coordinates(x), fk)
        return torch.cat([self._base_velocity(A, lay.momentum(x), qd_j), qd_j], dim=-1)
