"""Rotation utilities (euler-ZYX convention), batched over leading dims.

PyTorch counterpart of `wb_humanoid_mpc_tpu/utils/rotations.py`. The base
orientation is parameterized by intrinsic euler-ZYX angles stored as
``[theta_z, theta_y, theta_x]``:

    R(theta) = Rz(theta_z) @ Ry(theta_y) @ Rx(theta_x)

Every function takes tensors with arbitrary leading dims and works under
`torch.func` transforms (no in-place writes).
"""

from __future__ import annotations

import torch


def _mat(rows):
    """3x3 nested list of [...] tensors -> [..., 3, 3]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(v):
    """3-vector -> skew-symmetric matrix such that skew(a) @ b = a x b."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _mat([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def cross(a, b):
    """a x b over the last dim (written out: `torch.linalg.cross` broadcasting
    differs from `jnp.cross` on leading dims)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def euler_zyx_to_rot(euler_zyx):
    """[theta_z, theta_y, theta_x] -> world_R_body = Rz @ Ry @ Rx."""
    tz, ty, tx = euler_zyx[..., 0], euler_zyx[..., 1], euler_zyx[..., 2]
    return rot_z(tz) @ rot_y(ty) @ rot_x(tx)


def rot_to_euler_zyx(R):
    """Inverse of :func:`euler_zyx_to_rot`; theta_y in [-pi/2, pi/2]."""
    ty = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    tz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    tx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([tz, ty, tx], dim=-1)


def euler_zyx_rate_to_world_omega_map(euler_zyx):
    """E(theta) with omega_world = E @ [dtheta_z, dtheta_y, dtheta_x].

    Columns: e_z, Rz @ e_y, Rz @ Ry @ e_x (intrinsic ZYX composition).
    """
    tz, ty = euler_zyx[..., 0], euler_zyx[..., 1]
    cz, sz = torch.cos(tz), torch.sin(tz)
    cy, sy = torch.cos(ty), torch.sin(ty)
    zero, one = torch.zeros_like(tz), torch.ones_like(tz)
    return _mat([[zero, -sz, cz * cy], [zero, cz, sz * cy], [one, zero, -sy]])


def euler_zyx_rate_map_derivative(euler_zyx, rates):
    """dE/dt along the euler rates (the jvp JAX takes of
    `euler_zyx_rate_to_world_omega_map`, written out)."""
    tz, ty = euler_zyx[..., 0], euler_zyx[..., 1]
    tzd, tyd = rates[..., 0], rates[..., 1]
    cz, sz = torch.cos(tz), torch.sin(tz)
    cy, sy = torch.cos(ty), torch.sin(ty)
    zero = torch.zeros_like(tz)
    return _mat([
        [zero, -cz * tzd, -sz * tzd * cy - cz * sy * tyd],
        [zero, -sz * tzd, cz * tzd * cy - sz * sy * tyd],
        [zero, zero, -cy * tyd],
    ])


def world_omega_to_euler_zyx_rate_map(euler_zyx):
    """E(theta)^-1: world angular velocity -> euler-ZYX rates (closed form;
    singular at |theta_y| = pi/2, the reference's convention)."""
    tz, ty = euler_zyx[..., 0], euler_zyx[..., 1]
    cz, sz = torch.cos(tz), torch.sin(tz)
    cy, sy = torch.cos(ty), torch.sin(ty)
    ty_sec = 1.0 / cy
    zero, one = torch.zeros_like(tz), torch.ones_like(tz)
    return _mat([[cz * sy * ty_sec, sz * sy * ty_sec, one],
                 [-sz, cz, zero],
                 [cz * ty_sec, sz * ty_sec, zero]])


def quat_to_rot(q_wxyz):
    """Unit quaternion [w, x, y, z] -> rotation matrix."""
    w, x, y, z = q_wxyz[..., 0], q_wxyz[..., 1], q_wxyz[..., 2], q_wxyz[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _mat([[ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
                 [2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
                 [2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz]])


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [w, x, y, z] (Shepperd's method, the
    four cases selected branch-free with `torch.where`)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def case(diag, parts):
        s = torch.sqrt(torch.clamp(diag, min=1e-12)) * 2.0
        return torch.stack([0.25 * s if p is None else p / s for p in parts], dim=-1)

    d01, d10 = R[..., 0, 1] + R[..., 1, 0], R[..., 1, 0] - R[..., 0, 1]
    d02, d20 = R[..., 0, 2] + R[..., 2, 0], R[..., 0, 2] - R[..., 2, 0]
    d12, d21 = R[..., 1, 2] + R[..., 2, 1], R[..., 2, 1] - R[..., 1, 2]
    q_w = case(tr + 1.0, (None, d21, d20, d10))
    q_x = case(1.0 + m00 - m11 - m22, (d21, None, d01, d02))
    q_y = case(1.0 - m00 + m11 - m22, (d20, d01, None, d12))
    q_z = case(1.0 - m00 - m11 + m22, (d10, d02, d12, None))
    use_w = tr > 0.0
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)
    q = torch.where(use_w[..., None], q_w,
                    torch.where(use_x[..., None], q_x,
                                torch.where(use_y[..., None], q_y, q_z)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotation_error_world(R, R_ref):
    """3-dim orientation error vee(log(R @ R_ref^T)): the skew part of the
    relative rotation, scaled to the rotation angle (reference
    `EndEffectorKinematicCostHelpers.h:39-96`)."""
    E = R @ R_ref.transpose(-1, -2)
    w = torch.stack([E[..., 2, 1] - E[..., 1, 2], E[..., 0, 2] - E[..., 2, 0],
                     E[..., 1, 0] - E[..., 0, 1]], dim=-1)
    cos_a = torch.clamp(0.5 * (E.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0), -1.0, 1.0)
    angle = torch.arccos(cos_a)
    sin_a = torch.sin(angle)
    # w = 2 sin(a) axis, so a axis = w a / (2 sin a); 1/2 near a = 0
    big = sin_a > 1e-6
    scale = torch.where(big, angle / (2.0 * torch.where(big, sin_a, torch.ones_like(sin_a))),
                        torch.full_like(sin_a, 0.5))
    return w * scale[..., None]


def rpy_to_rot(rpy):
    """URDF rpy (fixed-axis XYZ, Rz(y) Ry(p) Rx(r)) -> rotation matrix."""
    return rot_z(rpy[..., 2]) @ rot_y(rpy[..., 1]) @ rot_x(rpy[..., 0])
