"""Rigid-body dynamics from the world-Jacobian contraction and one
Newton-Euler balance, batched over leading dims.

PyTorch counterpart of the parts of `wb_humanoid_mpc_tpu/models/dynamics.py`
that the whole-body flow map and OCP reach:
- M(q) = sum_b J_b^T I_b^W(q) J_b (`mass_matrix_from`), and its six base rows
  alone (`base_rows_mass_nle`), which is all the flow map needs because joint
  accelerations are inputs;
- nle(q, v) = sum_b J_b^T [F; N_o] from the bias wrenches
  (`nle_newton_euler`);
- the 6x6 base block solved by a statically unrolled Cholesky
  (`_spd_solve_unrolled`): no `torch.linalg` inside code that the LQ
  linearization differentiates with `torch.func`.
"""

from __future__ import annotations

import torch

from wb_humanoid_mpc_tpu_torch.models.kinematics import FK, VelBias, robot_tensors
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel
from wb_humanoid_mpc_tpu_torch.utils.rotations import cross, skew


def spatial_inertia_world(model: RobotModel, fk: FK) -> torch.Tensor:
    """[..., n_b, 6, 6] spatial inertia of each body at its origin, world axes.

    Acting on [v_origin; omega]: momentum [p_lin; L_origin] = I @ twist with
        p_lin = m v - h x omega,   L = I_o omega + h x v,   h = m * (R c).
    """
    rt = robot_tensors(model, fk.R.device, fk.R.dtype)
    m, c, Io, R = rt.mass, rt.com, rt.inertia_o, fk.R
    h_w = m[:, None] * torch.einsum("...bij,bj->...bi", R, c)
    Io_w = R @ Io @ R.transpose(-1, -2)
    Sh = skew(h_w)
    eye = rt.eye3.expand_as(Sh)
    top = torch.cat([m[:, None, None] * eye, -Sh], dim=-1)
    bot = torch.cat([Sh, Io_w], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mass_matrix_from(model: RobotModel, fk: FK, J: torch.Tensor) -> torch.Tensor:
    I_w = spatial_inertia_world(model, fk)
    return torch.einsum("...bri,...brs,...bsj->...ij", J, I_w, J)


def bias_wrenches(model: RobotModel, fk: FK, vb: VelBias) -> torch.Tensor:
    """[..., n_b, 6] net bias wrench of every body at its origin, world axes:

        F   = m (a_o + ω̇ × r_c + ω × (ω × r_c))        r_c = R c
        N_o = I_c^w ω̇ + ω × (I_c^w ω) + r_c × F         I_c^w = R I_c Rᵀ
    """
    rt = robot_tensors(model, fk.R.device, fk.R.dtype)
    m, c, Io = rt.mass, rt.com, rt.inertia_o
    Sc = skew(c)
    Ic = Io - m[:, None, None] * (Sc.transpose(-1, -2) @ Sc)
    R, w, dw, a_o = fk.R, vb.omega, vb.domega, vb.a_o
    r_c = torch.einsum("...bij,bj->...bi", R, c)
    a_c = a_o + cross(dw, r_c) + cross(w, cross(w, r_c))
    F = m[:, None] * a_c
    Ic_w = R @ Ic @ R.transpose(-1, -2)
    Icw_w = (Ic_w @ w[..., None])[..., 0]
    N_o = (Ic_w @ dw[..., None])[..., 0] + cross(w, Icw_w) + cross(r_c, F)
    return torch.cat([F, N_o], dim=-1)


def nle_newton_euler(model: RobotModel, fk: FK, vb: VelBias, J: torch.Tensor) -> torch.Tensor:
    """nle(q, v) = Σ_b J_bᵀ [F; N_o]."""
    return torch.einsum("...bri,...br->...i", J, bias_wrenches(model, fk, vb))


def base_rows_mass_nle(model: RobotModel, fk: FK, vb: VelBias, J: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M[:6, :], nle[:6]): only the floating-base rows."""
    I_w = spatial_inertia_world(model, fk)
    Jb = J[..., :6]
    M6 = torch.einsum("...bri,...brs,...bsj->...ij", Jb, I_w, J)
    nle6 = torch.einsum("...bri,...br->...i", Jb, bias_wrenches(model, fk, vb))
    return M6, nle6


def _spd_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A ([..., n, n]) by a statically unrolled
    Cholesky, elementwise over the leading dims."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def base_acceleration_rows(M6, nle6, qdd_joints, tau6):
    """Base acceleration from base-rows data only."""
    rhs = -nle6 - (M6[..., :, 6:] @ qdd_joints[..., None])[..., 0] + tau6
    return _spd_solve_unrolled(M6[..., :, :6], rhs)


def generalized_accelerations_rows(M6, nle6, qdd_joints, J_contacts, wrenches):
    """[a_base(6); qdd_joints]. J_contacts [..., n_c, 6, nq], wrenches [..., n_c, 6]."""
    tau6 = torch.einsum("...crm,...cr->...m", J_contacts[..., :6], wrenches)
    a_base = base_acceleration_rows(M6, nle6, qdd_joints, tau6)
    return torch.cat([a_base, qdd_joints], dim=-1)


def base_acceleration(M, nle, qdd_joints, tau_ext):
    """Solve the 6 base rows of M qdd + nle = tau_ext for the base acceleration."""
    rhs = -nle[..., :6] - (M[..., :6, 6:] @ qdd_joints[..., None])[..., 0] + tau_ext[..., :6]
    return _spd_solve_unrolled(M[..., :6, :6], rhs)


def joint_torques(model: RobotModel, M, nle, qdd_joints, J_contacts, wrenches):
    """Contact-consistent inverse dynamics -> actuated joint torques
    tau_j = [M qdd + nle - J^T W]_joints."""
    tau_ext = torch.einsum("...crn,...cr->...n", J_contacts, wrenches)
    a_base = base_acceleration(M, nle, qdd_joints, tau_ext)
    qdd = torch.cat([a_base, qdd_joints], dim=-1)
    return (M[..., 6:, :] @ qdd[..., None])[..., 0] + nle[..., 6:] - tau_ext[..., 6:]
