"""Centroidal-formulation OCP: the cost/constraint library as one node
function, batched over leading dims.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/centroidal_ocp.py`, with the
same terms (reference assembly `CentroidalMpcInterface.cpp:151-237`):
  - Q/R quadratic cost around (arm-swing nominal state, weight-comp input),
    terminal `terminalCostScaling * Q_final`
  - per-foot task-space cost with plane-tilt orientation error and
    impact-proximity-scaled velocity error
  - task-space link (torso) costs against per-node link references
  - ICP cost, per-leg external torque cost scaled by (1 - other-foot proximity)
  - joint-limit and foot/knee collision rows (hinge), friction cone and
    CoP-rectangle moment rows (relaxed log barrier)
  - hard equalities: stance 6-DoF twist with error feedback, swing zero
    wrench, swing normal-velocity tracking, joint mimics.

Every function takes x [..., nx], u [..., nu] and `NodeParams` with the same
leading dims: where JAX `vmap`s `fused_node` over nodes and line-search
candidates, the port calls it once on the batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.core.config import TaskConfig
from wb_humanoid_mpc_tpu_torch.models import dynamics as dyn
from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.models.centroidal_model import CentroidalModel
from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams, NodeTerms, masked_barrier_value
from wb_humanoid_mpc_tpu_torch.utils.rotations import cross

FRICTION_REGULARIZATION = 25.0  # reference FrictionForceConeConstraint.h:66-67 default


class NodeParams(NamedTuple):
    """Per-node reference data (leading dims: nodes, candidates)."""

    contact: torch.Tensor      # [..., 2] 1.0 if foot in contact
    z_pos: torch.Tensor        # [..., 2] swing/stance z reference
    z_vel: torch.Tensor        # [..., 2] swing z velocity reference
    proximity: torch.Tensor    # [..., 2] impact proximity factor
    x_ref: torch.Tensor        # [..., nx] nominal state (incl. arm swing)
    u_ref: torch.Tensor        # [..., nu] nominal input (weight compensating)
    torso_ref: torch.Tensor    # [..., n_ts_links, 18] = [p(3), R(9) row-major, v(3), omega(3)]


def _tilt_error(R, normal):
    """3-dim orientation-vs-plane error n x (R e_z): zero iff the frame
    z-axis aligns with the plane normal. R [..., 3, 3], normal [3]."""
    return cross(normal.expand_as(R[..., :, 2]), R[..., :, 2])


def _rotation_error(R, R_ref):
    """vee of the skew part of R R_ref^T, [..., 3]."""
    E = R @ R_ref.transpose(-1, -2)
    return 0.5 * torch.stack([E[..., 2, 1] - E[..., 1, 2], E[..., 0, 2] - E[..., 2, 0],
                              E[..., 1, 0] - E[..., 0, 1]], dim=-1)


class _Consts(NamedTuple):
    sqrt_Q: torch.Tensor
    sqrt_R: torch.Tensor
    sqrt_Qf: torch.Tensor
    sqrt_w: torch.Tensor            # task-space foot weights (the first 12 are used)
    sqrt_ts: tuple                  # per task-space link: its 12 weights
    sqrt_icp: torch.Tensor
    legs: tuple                     # per foot: None or (sqrt weights, joint index tensor)
    normal: torch.Tensor
    min_d: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor


def barrier_params(cfg: TaskConfig, n_joints: int, device, dtype) -> BarrierParams:
    """Penalty families of both formulations: cone + moment -> relaxed log
    barrier; joint limits + collision -> one-sided hinge."""
    c = cfg
    vals = (
        [c.contacts.friction_cone_barrier.mu] * 2 + [c.contacts.contact_moment_barrier.mu] * 8,
        [c.contacts.friction_cone_barrier.delta] * 2
        + [c.contacts.contact_moment_barrier.delta] * 8,
        [c.joint_limits_barrier.mu] * (2 * n_joints) + [c.collision.barrier.mu] * 16,
        [c.joint_limits_barrier.delta] * (2 * n_joints) + [c.collision.barrier.delta] * 16,
    )
    return BarrierParams(*(torch.tensor(v, dtype=dtype, device=device) for v in vals))


@dataclasses.dataclass(frozen=True)
class CentroidalOcp:
    model: CentroidalModel
    cfg: TaskConfig
    # the constants above as tensors, one set per (device, dtype); cleared
    # when a gain update changes the config (`interface.py`)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_eq(self) -> int:
        # 2 feet x (6 stance-twist/zero-wrench + 1 swing normal vel) + mimic rows
        return 14 + len(self.cfg.mimic_joints)

    def barrier_params(self, device, dtype) -> BarrierParams:
        return barrier_params(self.cfg, self.model.layout.n_joints, device, dtype)

    def _consts(self, device, dtype) -> _Consts:
        key = (torch.device(device), dtype)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        c = self.cfg
        col = c.collision
        robot = self.model.robot

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        legs = []
        for key_ in ("left_leg_torque_cost", "right_leg_torque_cost"):
            lt = c.leg_torque_costs.get(key_)
            legs.append(None if lt is None else (
                t(np.sqrt(lt.weights)),
                torch.tensor([6 + robot.joint_index(jn) for jn in lt.active_joint_names],
                             device=device)))
        hit = _Consts(
            sqrt_Q=t(np.sqrt(c.Q)), sqrt_R=t(np.sqrt(c.R)),
            sqrt_Qf=t(np.sqrt(np.asarray(c.Q_final) * c.terminal_cost_scaling)),
            sqrt_w=t(np.sqrt(c.task_space_foot_cost_weights)),
            sqrt_ts=tuple(t(np.sqrt(ts.weights[:12])) for ts in c.task_space_costs.values()),
            sqrt_icp=t(np.sqrt(c.icp_error_weight)),
            legs=tuple(legs),
            normal=t([0.0, 0.0, 1.0]),
            min_d=t([2.0 * col.foot_radius] * 9 + [2.0 * col.knee_radius]
                    + [2.0 * col.foot_radius] * 6),
            upper=t(robot.joint_upper), lower=t(robot.joint_lower))
        self._cache[key] = hit
        return hit

    def node_terms(self, t, x, u, p: NodeParams) -> NodeTerms:
        return self.fused_node(t, x, u, p)[0]

    def fused_node(self, t, x, u, p: NodeParams) -> tuple[NodeTerms, torch.Tensor]:
        """(NodeTerms, x_dot) sharing one FK / centroidal-momentum pass: the
        flow map's h_dot needs the contact positions and the COM, and its
        qb_dot is the base part of the generalized velocity the cost terms
        already recover."""
        c = self.cfg
        model = self.model
        lay = model.layout
        robot = model.robot
        k = self._consts(x.device, x.dtype)

        q = lay.generalized_coordinates(x)
        qd_j = lay.joint_input(u)
        fk = kin.forward_kinematics(robot, q)
        v = model.generalized_velocity(x, qd_j, fk)

        # ---------- Gauss-Newton residuals ----------
        rs = [k.sqrt_Q * (x - p.x_ref), k.sqrt_R * (u - p.u_ref)]

        # per-foot task-space cost (position reference: the origin, as in the
        # reference `CentroidalMpcEndEffectorFootCost.cpp:137`)
        w = k.sqrt_w
        foot_kin = []
        for i, frame in enumerate(model.contact_frames):
            R_f, p_f = kin.frame_transform(robot, fk, frame)
            J_f = kin.frame_jacobian(robot, fk, frame)
            twist = (J_f @ v[..., None])[..., 0]
            foot_kin.append((R_f, p_f, J_f, twist))
            rs.append(torch.cat([
                w[0:3] * p_f,
                w[3:6] * _tilt_error(R_f, k.normal),
                w[6:9] * twist[..., :3] * p.proximity[..., i:i + 1],
                w[9:12] * twist[..., 3:6],
            ], dim=-1))

        # task-space link costs
        for ts_idx, ts in enumerate(c.task_space_costs.values()):
            R_l, p_l = kin.frame_transform(robot, fk, ts.link_name)
            tw = (kin.frame_jacobian(robot, fk, ts.link_name) @ v[..., None])[..., 0]
            wl = k.sqrt_ts[ts_idx]
            ref = p.torso_ref[..., ts_idx, :]
            R_ref = ref[..., 3:12].reshape(*ref.shape[:-1], 3, 3)
            rs.append(torch.cat([
                wl[0:3] * (p_l - ref[..., 0:3]),
                wl[3:6] * _rotation_error(R_l, R_ref),
                wl[6:9] * (tw[..., :3] - ref[..., 12:15]),
                wl[9:12] * (tw[..., 3:6] - ref[..., 15:18]),
            ], dim=-1))

        # ICP / com-centering cost
        com = dyn.com_from_fk(robot, fk)
        mid = 0.5 * (foot_kin[0][1] + foot_kin[1][1])
        rs.append(k.sqrt_icp * (mid[..., :2] - com[..., :2]))

        # leg torque costs: tau_ext = (J^T W)_joints, scaled by the other
        # foot's proximity
        for i, leg in enumerate(k.legs):
            if leg is None:
                continue
            sqrt_wl, idx = leg
            J_f = foot_kin[i][2]
            tau_ext = (J_f.transpose(-1, -2) @ lay.contact_wrench(u, i)[..., None])[..., 0]
            scaler = 1.0 - p.proximity[..., 1 - i:2 - i]
            rs.append(sqrt_wl * tau_ext[..., idx] * scaler)

        r = torch.cat(rs, dim=-1)

        # ---------- relaxed-log-barrier rows ----------
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
        # all 16 reference sphere pairs in reference row order, inactive in
        # double support; masked rows park at 1.0 >> delta
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
        gz = fc.position_error_gain_z
        wrench_scale = 2.0 / (robot.total_mass * robot.gravity)
        g_rows = []
        for i in range(2):
            R_f, p_f, _, twist = foot_kin[i]
            ci = p.contact[..., i:i + 1]
            dz = p_f[..., 2:3] - p.z_pos[..., i:i + 1]
            lin = twist[..., :3]
            stance_rows = torch.cat([
                lin[..., 0:2], lin[..., 2:3] + gz * dz,
                twist[..., 3:6] + fc.orientation_error_gain * _tilt_error(R_f, k.normal),
            ], dim=-1)
            wrench_rows = lay.contact_wrench(u, i) * wrench_scale
            g_rows.append(ci * stance_rows + (1.0 - ci) * wrench_rows)
            normal_vel = twist[..., 2:3] + gz * dz - p.z_vel[..., i:i + 1]
            g_rows.append((1.0 - ci) * normal_vel)
        # joint mimic constraints (velocity level + position feedback)
        for mj in c.mimic_joints:
            ip = robot.joint_index(mj.parent_joint_name)
            ic = robot.joint_index(mj.child_joint_name)
            g_rows.append(mj.multiplier * qd_j[..., ip:ip + 1] - qd_j[..., ic:ic + 1]
                          + mj.position_gain * (mj.multiplier * qj[..., ip:ip + 1]
                                                - qj[..., ic:ic + 1]))
        g = torch.cat(g_rows, dim=-1)

        terms = NodeTerms(r=r, h_log=h_log, h_log_mask=h_log_mask, h_quad=h_quad, g=g)

        # ---------- flow map from the same pass ----------
        m_total = robot.total_mass
        f_sum = tau_sum = None
        for i in range(2):
            f_i = lay.contact_force(u, i)
            tau_i = cross(foot_kin[i][1] - com, f_i) + lay.contact_torque(u, i)
            f_sum = f_i if f_sum is None else f_sum + f_i
            tau_sum = tau_i if tau_sum is None else tau_sum + tau_i
        lin = f_sum / m_total
        lin = torch.cat([lin[..., :2], lin[..., 2:] - robot.gravity], dim=-1)
        x_dot = torch.cat([lin, tau_sum / m_total, v[..., :6], qd_j], dim=-1)
        return terms, x_dot

    def terminal_residual(self, t, x, p: NodeParams) -> torch.Tensor:
        """Terminal GN residual sqrt(scaling Q_final) (x - x_ref)."""
        return self._consts(x.device, x.dtype).sqrt_Qf * (x - p.x_ref)
