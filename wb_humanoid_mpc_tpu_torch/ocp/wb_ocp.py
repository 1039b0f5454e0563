"""Whole-body-formulation OCP: the torque-level cost/constraint library.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/wb_ocp.py`, with the same
terms (reference assembly `WBMpcInterface.cpp:131-199`):
  - Q/R quadratic cost over the state / input, terminal `terminalCostScaling * Q_final`
  - per-foot task-space cost incl. acceleration rows (18 weights)
  - friction cone and contact-moment rows (relaxed log barrier), joint limits
    and foot/knee collision (hinge)
  - hard equalities: stance zero foot acceleration with velocity/pose error
    feedback; swing zero wrench + vertical acceleration tracking; joint mimics.

Every function takes x [..., nx], u [..., nu] and `WBNodeParams` with the same
leading dims: where JAX `vmap`s `fused_node` over nodes and line-search
candidates, the port calls it once on the batch.

Frame accelerations are classical LOCAL_WORLD_ALIGNED accelerations
a_frame = J(q) a_gen + J̇ v. JAX takes J̇ v as a jvp of q -> J(q) v; the port
reads it off the bias accelerations the tree pass already carries
(`kinematics.frame_bias_acceleration`), which is the same quantity.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.core.config import TaskConfig
from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.models.wb_model import WholeBodyModel
from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams, NodeTerms, masked_barrier_value
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import (
    FRICTION_REGULARIZATION,
    _tilt_error,
    barrier_params,
)
from wb_humanoid_mpc_tpu_torch.ocp.params import weight_comp_input


class WBNodeParams(NamedTuple):
    contact: torch.Tensor      # [..., 2]
    z_pos: torch.Tensor        # [..., 2]
    z_vel: torch.Tensor        # [..., 2]
    z_acc: torch.Tensor        # [..., 2]
    proximity: torch.Tensor    # [..., 2]
    x_ref: torch.Tensor        # [..., nx]
    u_ref: torch.Tensor        # [..., nu]


class _Consts(NamedTuple):
    sqrt_Q: torch.Tensor
    sqrt_R: torch.Tensor
    sqrt_Qf: torch.Tensor
    sqrt_w: torch.Tensor       # 18 task-space foot weights
    sqrt_tau: torch.Tensor | None
    normal: torch.Tensor
    Av: torch.Tensor
    Aa: torch.Tensor
    min_d: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WholeBodyOcp:
    model: WholeBodyModel
    cfg: TaskConfig
    # the constants above as tensors, one set per (device, dtype); cleared
    # when a gain update changes the config (`interface.py`)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_eq(self) -> int:
        return 14 + len(self.cfg.mimic_joints)

    def _consts(self, device, dtype) -> _Consts:
        key = (torch.device(device), dtype)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        c = self.cfg
        fc = c.model_settings.foot_constraint
        col = c.collision

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        robot = self.model.robot
        hit = _Consts(
            sqrt_Q=t(np.sqrt(c.Q)), sqrt_R=t(np.sqrt(c.R)),
            sqrt_Qf=t(np.sqrt(np.asarray(c.Q_final) * c.terminal_cost_scaling)),
            sqrt_w=t(np.sqrt(c.task_space_foot_cost_weights)),
            sqrt_tau=(None if c.joint_torque_weights is None
                      else t(np.sqrt(c.joint_torque_weights))),
            normal=t([0.0, 0.0, 1.0]),
            Av=t([fc.linear_velocity_error_gain_xy, fc.linear_velocity_error_gain_xy,
                  fc.linear_velocity_error_gain_z] + [fc.angular_velocity_error_gain] * 3),
            Aa=t([fc.linear_acceleration_error_gain_xy, fc.linear_acceleration_error_gain_xy,
                  fc.linear_acceleration_error_gain_z] + [fc.angular_acceleration_error_gain] * 3),
            min_d=t([2.0 * col.foot_radius] * 9 + [2.0 * col.knee_radius]
                    + [2.0 * col.foot_radius] * 6),
            upper=t(robot.joint_upper), lower=t(robot.joint_lower))
        self._cache[key] = hit
        return hit

    def barrier_params(self, device, dtype) -> BarrierParams:
        """Penalty families: cone + moment -> relaxed log barrier; joint limits
        + collision -> one-sided hinge (the centroidal OCP's rows)."""
        return barrier_params(self.cfg, self.model.layout.n_joints, device, dtype)

    def node_terms(self, t, x, u, p: WBNodeParams) -> NodeTerms:
        return self.fused_node(t, x, u, p)[0]

    def fused_node(self, t, x, u, p: WBNodeParams) -> tuple[NodeTerms, torch.Tensor]:
        """(NodeTerms, x_dot) sharing one FK/dynamics pass."""
        c = self.cfg
        model = self.model
        lay = model.layout
        robot = model.robot
        k = self._consts(x.device, x.dtype)

        q = lay.generalized_coordinates(x)
        v = lay.generalized_velocities(x)
        qdd_j = lay.joint_input(u)
        W = lay.contact_wrenches(u)

        fk, vb = kin.forward_kinematics_vel(robot, q, v)
        J_all = kin.all_body_jacobians(robot, fk)
        M6, nle6 = dyn.base_rows_mass_nle(robot, fk, vb, J_all)
        J_c = torch.stack([kin.frame_jacobian(robot, fk, f) for f in model.contact_frames],
                          dim=-3)
        a_gen = dyn.generalized_accelerations_rows(M6, nle6, qdd_j, J_c, W)

        foot_kin = []
        for i, frame in enumerate(model.contact_frames):
            R_f, p_f = kin.frame_transform(robot, fk, frame)
            J_f = J_c[..., i, :, :]
            twist = (J_f @ v[..., None])[..., 0]
            acc = ((J_f @ a_gen[..., None])[..., 0]
                   + kin.frame_bias_acceleration(robot, fk, vb, frame))
            foot_kin.append((R_f, p_f, twist, acc))

        # ---------- Gauss-Newton residuals ----------
        w = k.sqrt_w
        rs = [k.sqrt_Q * (x - p.x_ref), k.sqrt_R * (u - p.u_ref)]
        for i in range(2):
            R_f, p_f, twist, acc = foot_kin[i]
            rs.append(torch.cat([
                w[0:3] * p_f,
                w[3:6] * _tilt_error(R_f, k.normal),
                w[6:9] * twist[..., :3] * p.proximity[..., i:i + 1],
                w[9:12] * twist[..., 3:6],
                w[12:15] * acc[..., :3],
                w[15:18] * acc[..., 3:6],
            ], dim=-1))
        if k.sqrt_tau is not None:
            M_full = dyn.mass_matrix_from(robot, fk, J_all)
            nle_full = dyn.nle_newton_euler(robot, fk, vb, J_all)
            rs.append(k.sqrt_tau * dyn.joint_torques(robot, M_full, nle_full, qdd_j, J_c, W))
        r = torch.cat(rs, dim=-1)

        # ---------- relaxed-log-barrier rows (cone, moment) ----------
        h_rows, h_masks = [], []
        mu_f = c.contacts.friction_coefficient
        for i in range(2):
            f_w = lay.contact_force(u, i)
            cone = mu_f * f_w[..., 2:3] - torch.sqrt(
                f_w[..., 0:1] ** 2 + f_w[..., 1:2] ** 2 + FRICTION_REGULARIZATION)
            h_rows.append(masked_barrier_value(cone, p.contact[..., i:i + 1]))
            h_masks.append(p.contact[..., i:i + 1].expand(cone.shape))
        ct = c.contacts
        for i in range(2):
            RT = foot_kin[i][0].transpose(-1, -2)
            f_l = (RT @ lay.contact_force(u, i)[..., None])[..., 0]
            m_l = (RT @ lay.contact_torque(u, i)[..., None])[..., 0]
            rows = torch.stack([
                m_l[..., 0] - ct.rectangle_y_min * f_l[..., 2],
                -m_l[..., 0] + ct.rectangle_y_max * f_l[..., 2],
                -m_l[..., 1] - ct.rectangle_x_min * f_l[..., 2],
                m_l[..., 1] + ct.rectangle_x_max * f_l[..., 2],
            ], dim=-1)
            h_rows.append(masked_barrier_value(rows, p.contact[..., i:i + 1]))
            h_masks.append(p.contact[..., i:i + 1].expand(rows.shape))
        h_log = torch.cat(h_rows, dim=-1)
        h_log_mask = torch.cat(h_masks, dim=-1)

        # ---------- hinge-barrier rows (joint limits + collision) ----------
        # all 16 reference sphere pairs in reference row order; masked rows
        # park at 1.0 >> delta (value and derivatives exactly zero)
        col_active = 1.0 - p.contact[..., 0:1] * p.contact[..., 1:2]
        cl, cr = model.contact_frames

        def fpos(name):
            return kin.frame_transform(robot, fk, name)[1]

        l_c, r_c = foot_kin[0][1], foot_kin[1][1]
        l1, l2 = fpos(f"{cl}_collision_p_1"), fpos(f"{cl}_collision_p_2")
        r1, r2 = fpos(f"{cr}_collision_p_1"), fpos(f"{cr}_collision_p_2")
        ankle_l, ankle_r = fpos(c.collision.left_ankle_frame), fpos(c.collision.right_ankle_frame)
        knee_l, knee_r = fpos(c.collision.left_knee_frame), fpos(c.collision.right_knee_frame)
        pairs = [
            (l1, r1), (l1, r2), (l2, r1), (l2, r2),
            (l_c, r1), (l_c, r2), (r_c, l1), (r_c, l2),
            (l_c, r_c),
            (knee_l, knee_r),
            (l_c, ankle_r), (l1, ankle_r), (l2, ankle_r),
            (r_c, ankle_l), (r1, ankle_l), (r2, ankle_l),
        ]
        dists = torch.stack([torch.sqrt(torch.sum((a - b) ** 2, dim=-1) + 1e-12)
                             for a, b in pairs], dim=-1) - k.min_d
        coll_rows = masked_barrier_value(dists, col_active, safe_value=1.0)
        qj = lay.joint_angles(x)
        h_quad = torch.cat([k.upper - qj, qj - k.lower, coll_rows], dim=-1)

        # ---------- equality constraints ----------
        fc = c.model_settings.foot_constraint
        wrench_scale = 2.0 / (robot.total_mass * robot.gravity)
        g_rows = []
        for i in range(2):
            R_f, p_f, twist, acc = foot_kin[i]
            ci = p.contact[..., i:i + 1]
            dz = p_f[..., 2:3] - p.z_pos[..., i:i + 1]
            pose_err = torch.cat([torch.zeros_like(dz), torch.zeros_like(dz),
                                  fc.position_error_gain_z * dz,
                                  fc.orientation_error_gain * _tilt_error(R_f, k.normal)], dim=-1)
            stance_rows = k.Aa * acc + k.Av * twist + pose_err
            wrench_rows = lay.contact_wrench(u, i) * wrench_scale
            g_rows.append(ci * stance_rows + (1.0 - ci) * wrench_rows)
            swing_row = (
                fc.linear_acceleration_error_gain_z * (acc[..., 2:3] - p.z_acc[..., i:i + 1])
                + fc.linear_velocity_error_gain_z * (twist[..., 2:3] - p.z_vel[..., i:i + 1])
                + fc.position_error_gain_z * dz
            )
            g_rows.append((1.0 - ci) * swing_row)
        # joint mimic constraints at acceleration level w/ vel+pos feedback
        vj = lay.joint_velocities(x)
        for mj in c.mimic_joints:
            ip = robot.joint_index(mj.parent_joint_name)
            ic = robot.joint_index(mj.child_joint_name)
            g_rows.append(
                mj.multiplier * qdd_j[..., ip:ip + 1] - qdd_j[..., ic:ic + 1]
                + mj.velocity_gain * (mj.multiplier * vj[..., ip:ip + 1] - vj[..., ic:ic + 1])
                + mj.position_gain * (mj.multiplier * qj[..., ip:ip + 1] - qj[..., ic:ic + 1]))
        g = torch.cat(g_rows, dim=-1)

        terms = NodeTerms(r=r, h_log=h_log, h_log_mask=h_log_mask, h_quad=h_quad, g=g)
        return terms, torch.cat([v, a_gen], dim=-1)

    def terminal_residual(self, t, x, p: WBNodeParams) -> torch.Tensor:
        return self._consts(x.device, x.dtype).sqrt_Qf * (x - p.x_ref)


def make_wb_node_params(ocp: WholeBodyOcp, swing, x_ref: torch.Tensor) -> WBNodeParams:
    """SwingReference (numpy arrays [N+1, 2]) + target states x_ref [N+1, nx]
    -> per-node params on x_ref's device, in its dtype."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=x_ref.dtype,
                               device=x_ref.device)

    contact = t(swing.contact_flags)
    robot = ocp.model.robot
    return WBNodeParams(
        contact=contact, z_pos=t(swing.z_pos), z_vel=t(swing.z_vel), z_acc=t(swing.z_acc),
        proximity=t(swing.proximity), x_ref=x_ref,
        u_ref=weight_comp_input(robot.total_mass, robot.gravity, contact,
                                ocp.model.layout.input_dim))
