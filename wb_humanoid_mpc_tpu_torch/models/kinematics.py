"""Forward kinematics + geometric Jacobians, batched over leading dims.

PyTorch counterpart of `wb_humanoid_mpc_tpu/models/kinematics.py`, with the
same conventions:
- generalized velocity v == dq/dt, base coords [world linear velocity (3),
  euler-ZYX rates (3)];
- 6-vectors are ordered [linear(3), angular(3)];
- Jacobians are LOCAL_WORLD_ALIGNED.

The tree pass is level-parallel: joints are grouped by tree depth
(`_tree_levels`) and each level is one batched transform update over all of
its joints, so the sequential depth is the tree depth (7 for the 23-joint
humanoid), not the joint count. Where JAX `vmap`s these functions over nodes
or candidates, the port passes q, v with leading dims; everything is free of
in-place writes so `torch.func.jvp`/`vmap` can differentiate through it.

`forward_kinematics_vel` batched is the plain version of the CUDA FK kernel
(`ops/fkvel.py`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel
from wb_humanoid_mpc_tpu_torch.utils.rotations import (
    cross,
    euler_zyx_rate_map_derivative,
    euler_zyx_rate_to_world_omega_map,
    euler_zyx_to_rot,
    skew,
)


@functools.lru_cache(maxsize=None)
def _tree_levels(parent_bodies: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """Group joint indices by kinematic-tree depth. All joints within a level
    have parents in strictly earlier levels, so one level is one batched
    transform update."""
    n_j = len(parent_bodies)
    depth = np.zeros(n_j, dtype=np.int64)
    for j, pb in enumerate(parent_bodies):
        depth[j] = 0 if pb == 0 else depth[pb - 1] + 1
    return tuple(
        np.nonzero(depth == d)[0].astype(np.int64) for d in range(int(depth.max()) + 1)
    ) if n_j else ()


class _Level(NamedTuple):
    joints: list          # joint indices of this level (python ints)
    parents: list         # parent body of each joint (python ints)
    idx: torch.Tensor     # the joint indices as a device tensor
    K: torch.Tensor       # [k,3,3] skew(axis)
    KK: torch.Tensor      # [k,3,3] skew(axis)^2
    jR: torch.Tensor      # [k,3,3] parent body -> joint frame
    jp: torch.Tensor      # [k,3,1] joint origin in the parent body
    ax_c: torch.Tensor    # [k,3,1] joint axis in the parent body (jR @ axis)


class RobotTensors(NamedTuple):
    """The `RobotModel` arrays as tensors on one device in one dtype."""

    levels: tuple
    axis: torch.Tensor           # [n_j,3]
    mass: torch.Tensor           # [n_b]
    com: torch.Tensor            # [n_b,3]
    inertia_o: torch.Tensor      # [n_b,3,3]
    ancestor_mask: torch.Tensor  # [n_b,nq] 0/1
    joint_lower: torch.Tensor
    joint_upper: torch.Tensor
    frames: dict                 # name -> (body, R [3,3], p [3], mask [nq])
    eye3: torch.Tensor


def robot_tensors(model: RobotModel, device, dtype) -> RobotTensors:
    """Tensors of `model` on (device, dtype), built once and cached on the model."""
    device = torch.device(device)
    key = (device, dtype)
    hit = model.tensor_cache.get(key)
    if hit is not None:
        return hit

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    axis = np.asarray(model.joint_axis, dtype=np.float64)
    K = np.zeros((len(axis), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    KK = np.einsum("kij,kjl->kil", K, K)
    jR = np.asarray(model.joint_R, dtype=np.float64)
    jp = np.asarray(model.joint_p, dtype=np.float64)
    ax_c = np.einsum("kij,kj->ki", jR, axis)
    parents = np.asarray(model.joint_parent_body)
    levels = []
    for idx in _tree_levels(tuple(int(p) for p in parents)):
        levels.append(_Level(
            joints=[int(j) for j in idx], parents=[int(parents[j]) for j in idx],
            idx=torch.as_tensor(idx, device=device),
            K=t(K[idx]), KK=t(KK[idx]), jR=t(jR[idx]),
            jp=t(jp[idx])[:, :, None], ax_c=t(ax_c[idx])[:, :, None]))
    frames = {
        name: (f.body, t(f.R), t(f.p), t(model.ancestor_mask[f.body]))
        for name, f in model.frames.items()
    }
    out = RobotTensors(
        levels=tuple(levels), axis=t(axis), mass=t(model.mass), com=t(model.com),
        inertia_o=t(model.inertia_o), ancestor_mask=t(model.ancestor_mask),
        joint_lower=t(model.joint_lower), joint_upper=t(model.joint_upper),
        frames=frames, eye3=t(np.eye(3)))
    model.tensor_cache[key] = out
    return out


class FK(NamedTuple):
    """World-frame kinematics of every body (leading batch dims first)."""

    R: torch.Tensor               # [..., n_b, 3, 3] body orientation in world
    p: torch.Tensor               # [..., n_b, 3]    body origin in world
    joint_axis_w: torch.Tensor    # [..., n_j, 3]    world-frame joint axes
    joint_origin_w: torch.Tensor  # [..., n_j, 3]    world-frame joint origins
    E_base: torch.Tensor          # [..., 3, 3] euler-rate -> world angular velocity


class VelBias(NamedTuple):
    """Per-body twists + bias (zero-q̈) accelerations at the body origin, world
    axes. The base linear bias acceleration is seeded with +g ẑ, so the
    Newton-Euler balance on these biases yields C(q,v)v + g(q) directly."""

    v_o: torch.Tensor     # [..., n_b, 3]
    omega: torch.Tensor   # [..., n_b, 3]
    a_o: torch.Tensor     # [..., n_b, 3]
    domega: torch.Tensor  # [..., n_b, 3]


def _level_block(lvl: _Level, qj, batch):
    """[..., k, 3, 5] parent-frame block [jR @ rod | jp | ax_c] of one level."""
    k = len(lvl.joints)
    s = torch.sin(qj)[..., None, None]
    c = torch.cos(qj)[..., None, None]
    eye = torch.eye(3, dtype=qj.dtype, device=qj.device)
    rod = eye + s * lvl.K + (1.0 - c) * lvl.KK
    M_l = lvl.jR @ rod
    return torch.cat([M_l, lvl.jp.expand(*batch, k, 3, 1),
                      lvl.ax_c.expand(*batch, k, 3, 1)], dim=-1)


def _gather(states, bodies, dim):
    return torch.stack([states[b] for b in bodies], dim=dim)


def forward_kinematics(model: RobotModel, q: torch.Tensor) -> FK:
    """FK for q = [p_base(3), theta_zyx(3), q_joints] with leading dims."""
    rt = robot_tensors(model, q.device, q.dtype)
    batch = q.shape[:-1]
    qj = q[..., 6:]
    R = [euler_zyx_to_rot(q[..., 3:6])] + [None] * model.n_joints
    p = [q[..., 0:3]] + [None] * model.n_joints
    for lvl in rt.levels:
        Rp = _gather(R, lvl.parents, -3)                     # [...,k,3,3]
        pp = _gather(p, lvl.parents, -2)                     # [...,k,3]
        out = Rp @ _level_block(lvl, qj[..., lvl.idx], batch)  # [...,k,3,5]
        p_child = pp + out[..., 3]
        for i, j in enumerate(lvl.joints):
            R[j + 1] = out[..., i, :, 0:3]
            p[j + 1] = p_child[..., i, :]
    R_all = torch.stack(R, dim=-3)
    p_all = torch.stack(p, dim=-2)
    axes_w = torch.einsum("...kij,kj->...ki", R_all[..., 1:, :, :], rt.axis)
    return FK(R=R_all, p=p_all, joint_axis_w=axes_w, joint_origin_w=p_all[..., 1:, :],
              E_base=euler_zyx_rate_to_world_omega_map(q[..., 3:6]))


def forward_kinematics_vel(model: RobotModel, q: torch.Tensor, v: torch.Tensor
                           ) -> tuple[FK, VelBias]:
    """One level-parallel pass: FK + body twists + bias accelerations."""
    rt = robot_tensors(model, q.device, q.dtype)
    batch = q.shape[:-1]
    theta, thetad = q[..., 3:6], v[..., 3:6]
    qj, vj = q[..., 6:], v[..., 6:]
    E = euler_zyx_rate_to_world_omega_map(theta)
    dE = euler_zyx_rate_map_derivative(theta, thetad)
    omega0 = (E @ thetad[..., None])[..., 0]
    domega0 = (dE @ thetad[..., None])[..., 0]       # Ė θ̇  (θ̈ = 0)
    g_up = torch.zeros_like(omega0)
    g_up = torch.cat([g_up[..., :2], g_up[..., 2:] + model.gravity], dim=-1)

    n = model.n_joints
    R = [euler_zyx_to_rot(theta)] + [None] * n
    p = [q[..., 0:3]] + [None] * n
    vo = [v[..., 0:3]] + [None] * n
    w = [omega0] + [None] * n
    ao = [g_up] + [None] * n
    dw = [domega0] + [None] * n
    for lvl in rt.levels:
        Rp = _gather(R, lvl.parents, -3)
        pp, vp, wp, ap, dwp = (_gather(s, lvl.parents, -2) for s in (p, vo, w, ao, dw))
        qd = vj[..., lvl.idx][..., None]                     # [...,k,1]
        out = Rp @ _level_block(lvl, qj[..., lvl.idx], batch)
        r = out[..., 3]                                      # o_j - p_parent (world)
        axis_w = out[..., 4]
        wxr = cross(wp, r)
        p_c = pp + r
        v_c = vp + wxr
        w_c = wp + axis_w * qd
        a_c = ap + cross(dwp, r) + cross(wp, wxr)
        dw_c = dwp + cross(wp, axis_w) * qd
        for i, j in enumerate(lvl.joints):
            R[j + 1] = out[..., i, :, 0:3]
            p[j + 1], vo[j + 1], w[j + 1] = p_c[..., i, :], v_c[..., i, :], w_c[..., i, :]
            ao[j + 1], dw[j + 1] = a_c[..., i, :], dw_c[..., i, :]
    R_all = torch.stack(R, dim=-3)
    p_all = torch.stack(p, dim=-2)
    axes_w = torch.einsum("...kij,kj->...ki", R_all[..., 1:, :, :], rt.axis)
    fk = FK(R=R_all, p=p_all, joint_axis_w=axes_w, joint_origin_w=p_all[..., 1:, :], E_base=E)
    vb = VelBias(v_o=torch.stack(vo, dim=-2), omega=torch.stack(w, dim=-2),
                 a_o=torch.stack(ao, dim=-2), domega=torch.stack(dw, dim=-2))
    return fk, vb


def point_jacobian(model: RobotModel, fk: FK, point_w: torch.Tensor,
                   body_mask: torch.Tensor) -> torch.Tensor:
    """[..., 6, nq] LOCAL_WORLD_ALIGNED Jacobian of a point rigidly attached to
    the body whose ancestor mask (0/1 over nq) is `body_mask`."""
    E = fk.E_base
    r_base = point_w - fk.p[..., 0, :]
    J_lin_base_t = torch.eye(3, dtype=E.dtype, device=E.device).expand_as(E)
    J_ang_base_t = torch.zeros_like(E)
    J_lin_base_r = -skew(r_base) @ E
    a = fk.joint_axis_w                        # [...,n_j,3]
    r = point_w[..., None, :] - fk.joint_origin_w
    J_lin_j = cross(a, r)
    J_lin = torch.cat([J_lin_base_t, J_lin_base_r, J_lin_j.transpose(-1, -2)], dim=-1)
    J_ang = torch.cat([J_ang_base_t, E, a.transpose(-1, -2)], dim=-1)
    return torch.cat([J_lin, J_ang], dim=-2) * body_mask


def all_body_jacobians(model: RobotModel, fk: FK) -> torch.Tensor:
    """Stacked [..., n_b, 6, nq] Jacobians of every body origin."""
    rt = robot_tensors(model, fk.p.device, fk.p.dtype)
    n_b, n_j = model.n_bodies, model.n_joints
    x = fk.p                                             # [...,n_b,3]
    E = fk.E_base[..., None, :, :].expand(*x.shape[:-2], n_b, 3, 3)
    r_base = x - x[..., 0:1, :]
    J_lin_base_r = -skew(r_base) @ E
    J_lin_base_t = rt.eye3.expand_as(E)
    J_ang_base_t = torch.zeros_like(E)
    a = fk.joint_axis_w[..., None, :, :]                 # [...,1,n_j,3]
    r = x[..., :, None, :] - fk.joint_origin_w[..., None, :, :]  # [...,n_b,n_j,3]
    J_lin_j = cross(a.expand_as(r), r)
    J_ang_j = a.expand_as(r)
    J_lin = torch.cat([J_lin_base_t, J_lin_base_r, J_lin_j.transpose(-1, -2)], dim=-1)
    J_ang = torch.cat([J_ang_base_t, E, J_ang_j.transpose(-1, -2)], dim=-1)
    J = torch.cat([J_lin, J_ang], dim=-2)                # [...,n_b,6,nq]
    return J * rt.ancestor_mask[:, None, :]


def frame_transform(model: RobotModel, fk: FK, frame_name: str):
    """World (R, p) of a named fixed frame."""
    body, fR, fp, _ = robot_tensors(model, fk.p.device, fk.p.dtype).frames[frame_name]
    Rb, pb = fk.R[..., body, :, :], fk.p[..., body, :]
    return Rb @ fR, pb + (Rb @ fp[:, None])[..., 0]


def frame_jacobian(model: RobotModel, fk: FK, frame_name: str) -> torch.Tensor:
    """[..., 6, nq] LOCAL_WORLD_ALIGNED Jacobian of a named fixed frame."""
    mask = robot_tensors(model, fk.p.device, fk.p.dtype).frames[frame_name][3]
    _, p_w = frame_transform(model, fk, frame_name)
    return point_jacobian(model, fk, p_w, mask)


def frame_velocity(model: RobotModel, fk: FK, frame_name: str, v: torch.Tensor) -> torch.Tensor:
    """[linear; angular] world-aligned twist of a frame given generalized vel v."""
    return (frame_jacobian(model, fk, frame_name) @ v[..., None])[..., 0]


def frame_bias_acceleration(model: RobotModel, fk: FK, vb: VelBias,
                            frame_name: str) -> torch.Tensor:
    """[..., 6] classical acceleration of a frame at zero q̈ (J̇ v), from the
    bias accelerations of its body: a = a_o - g ẑ + ω̇ × r + ω × (ω × r).

    JAX takes the same quantity as a jvp of q -> J(q) v along v
    (`ocp/wb_ocp.py:124-135`); the recursion already carries it, so the port
    reads it off instead of nesting a second forward-mode pass.
    """
    body = robot_tensors(model, fk.p.device, fk.p.dtype).frames[frame_name][0]
    _, p_w = frame_transform(model, fk, frame_name)
    r = p_w - fk.p[..., body, :]
    w, dw = vb.omega[..., body, :], vb.domega[..., body, :]
    a_o = vb.a_o[..., body, :]
    a_o = torch.cat([a_o[..., :2], a_o[..., 2:] - model.gravity], dim=-1)
    lin = a_o + cross(dw, r) + cross(w, cross(w, r))
    return torch.cat([lin, dw], dim=-1)
