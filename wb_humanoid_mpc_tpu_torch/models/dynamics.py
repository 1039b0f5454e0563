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
  linearization differentiates with `torch.func`;
- for the centroidal formulation: the COM (`com_position`), the centroidal
  momentum matrix A_G(q) (`centroidal_momentum_matrix`) and h_G / m
  (`normalized_centroidal_momentum`); and the full-matrix helpers
  `mass_matrix`, `mass_and_nle`, `nonlinear_effects` and
  `generalized_accelerations`.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from wb_humanoid_mpc_tpu_torch.models.kinematics import (
    FK,
    VelBias,
    all_body_jacobians,
    forward_kinematics,
    forward_kinematics_vel,
    robot_tensors,
)
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


def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., nq, nq] generalized mass matrix (CRBA equivalent)."""
    fk = forward_kinematics(model, q)
    return mass_matrix_from(model, fk, all_body_jacobians(model, fk))


def com_from_fk(model: RobotModel, fk: FK) -> torch.Tensor:
    """[..., 3] world COM from a kinematics pass."""
    rt = robot_tensors(model, fk.R.device, fk.R.dtype)
    com_w = fk.p + torch.einsum("...bij,bj->...bi", fk.R, rt.com)
    return (rt.mass[:, None] * com_w).sum(-2) / rt.mass.sum()


def com_position(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[..., 3] world COM at q."""
    return com_from_fk(model, forward_kinematics(model, q))


def kinetic_energy(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[...] kinetic energy 1/2 v^T M(q) v."""
    return 0.5 * torch.einsum("...i,...ij,...j->...", v, mass_matrix(model, q), v)


def potential_energy(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """[...] gravitational potential energy, zero at z = 0."""
    fk = forward_kinematics(model, q)
    rt = robot_tensors(model, fk.R.device, fk.R.dtype)
    com_w = fk.p + torch.einsum("...bij,bj->...bi", fk.R, rt.com)
    return model.gravity * (rt.mass * com_w[..., 2]).sum(-1)


class MassNle(NamedTuple):
    M: torch.Tensor
    nle: torch.Tensor
    fk: FK
    J: torch.Tensor  # [..., n_b, 6, nq] body Jacobians


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


def mass_and_nle(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> MassNle:
    """(M, nle, fk, J) from one level-parallel kinematics pass: M by the
    world-Jacobian contraction, nle by the Newton-Euler balance."""
    fk, vb = forward_kinematics_vel(model, q, v)
    J = all_body_jacobians(model, fk)
    return MassNle(mass_matrix_from(model, fk, J), nle_newton_euler(model, fk, vb, J), fk, J)


def nonlinear_effects(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """nle(q, v) = C(q,v) v + g(q)."""
    return mass_and_nle(model, q, v).nle


def centroidal_momentum_matrix_from(model: RobotModel, fk: FK) -> torch.Tensor:
    """A_G from a kinematics pass: [..., 6, nq], h_G = A_G v with
    h_G = [linear; angular about the COM]."""
    J = all_body_jacobians(model, fk)
    I_w = spatial_inertia_world(model, fk)
    # momentum of each body about its own origin -> about the world origin:
    # p_lin unchanged; L_O = L_b + p_b x p_lin
    A_b = I_w @ J                                          # [..., n_b, 6, nq]
    lin = A_b[..., 0:3, :]
    ang_O = A_b[..., 3:6, :] + skew(fk.p) @ lin
    lin = lin.sum(-3)
    ang_O = ang_O.sum(-3)
    # from the world origin to the COM: L_G = L_O - p_com x p_lin
    ang_G = ang_O - skew(com_from_fk(model, fk)) @ lin
    return torch.cat([lin, ang_G], dim=-2)


def centroidal_momentum_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """A_G(q): [..., 6, nq]."""
    return centroidal_momentum_matrix_from(model, forward_kinematics(model, q))


def normalized_centroidal_momentum(model: RobotModel, q: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """h_G / total_mass, the centroidal state's momentum."""
    return (centroidal_momentum_matrix(model, q) @ v[..., None])[..., 0] / model.total_mass


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


def generalized_accelerations(model: RobotModel, M, nle, qdd_joints, J_contacts, wrenches):
    """[a_base(6); qdd_joints] from the full M, nle given joint accelerations
    and contact wrenches (J_contacts [..., n_c, 6, nq], wrenches [..., n_c, 6])."""
    tau_ext = torch.einsum("...crn,...cr->...n", J_contacts, wrenches)
    a_base = base_acceleration(M, nle, qdd_joints, tau_ext)
    return torch.cat([a_base, qdd_joints], dim=-1)
