"""Equality-constraint projection for the LQ subproblem.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/projection.py` (the
reference's `projectStateInputEqualityConstraints` path). Per node, with the
linearized constraint g + Cx dx + Du du = 0 (Du: [nc, nu]), the control splits
into du = L dx + Z dz + w with

    L = -Du^+ Cx,   w = -Du^+ g,     Du^+ = Du^T (Du Du^T + eps I)^-1,
    Z = orthonormal null-space basis of Du (last nu-nc columns of the
        complete QR of Du^T),

and the stage data transform to the reduced coordinates (dx, dz):

    A' = A + B L          B' = B Z          d' = d + B w
    Qxx' = Qxx + L^T Quu L + L^T Qux + Qux^T L
    Quu' = Z^T Quu Z      Qux' = Z^T (Quu L + Qux)
    qx' = qx + L^T (qu + Quu w) + Qux^T w
    qu' = Z^T (qu + Quu w)

All nodes at once (`project_lq`): a batched Cholesky (`solver/riccati.py::
cholesky`) and `torch.linalg.qr` (this code is not differentiated, so the
library factorizations are fine here); `project_node` is one node of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcbench.reference.solver.riccati import cholesky
from mpcbench.reference.solver.transcription import LQApprox


class ProjectionData(NamedTuple):
    L: torch.Tensor   # [N, nu, nx]
    Z: torch.Tensor   # [N, nu, nz]
    w: torch.Tensor   # [N, nu]


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def project_lq(lq: LQApprox, Cx: torch.Tensor, Du: torch.Tensor, g: torch.Tensor,
               eps: float = 1e-8) -> tuple[LQApprox, ProjectionData]:
    """Cx [N, nc, nx], Du [N, nc, nu], g [N, nc] -> (reduced LQ with control
    dim nz = nu - nc, recovery map (L, Z, w))."""
    nc = Du.shape[-2]
    eye = torch.eye(nc, dtype=Du.dtype, device=Du.device)
    DuT = Du.transpose(-1, -2)
    # damped pseudo-inverse rows (handles masked zero rows); damping relative
    # to the row scale keeps float32 well conditioned
    M0 = Du @ DuT
    scale = torch.clamp(torch.amax(torch.diagonal(M0, dim1=-2, dim2=-1), dim=-1), min=1.0)
    M = M0 + (eps * scale)[..., None, None] * eye
    Lchol = cholesky(0.5 * (M + M.transpose(-1, -2)))
    Dp = torch.cholesky_solve(eye.expand_as(M), Lchol)
    Dpinv = DuT @ Dp                                    # [N, nu, nc]
    L = -Dpinv @ Cx                                     # [N, nu, nx]
    w = -_mv(Dpinv, g)                                  # [N, nu]
    Q, _ = torch.linalg.qr(DuT, mode="complete")        # [N, nu, nu]
    Z = Q[..., nc:]                                     # [N, nu, nz]

    A, B, d, Qxx, Quu, Qux, qx, qu = lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu
    LT, ZT = L.transpose(-1, -2), Z.transpose(-1, -2)
    QuuL = Quu @ L
    qu_w = qu + _mv(Quu, w)
    reduced = LQApprox(
        A=A + B @ L, B=B @ Z, d=d + _mv(B, w),
        Qxx=Qxx + LT @ QuuL + LT @ Qux + Qux.transpose(-1, -2) @ L,
        Quu=ZT @ Quu @ Z, Qux=ZT @ (QuuL + Qux),
        qx=qx + _mv(LT, qu_w) + _mv(Qux.transpose(-1, -2), w), qu=_mv(ZT, qu_w),
        QN=lq.QN, qN=lq.qN, cost=lq.cost, g_norm=lq.g_norm, defect_norm=lq.defect_norm)
    return reduced, ProjectionData(L=L, Z=Z, w=w)


def project_node(eps: float = 1e-8):
    """Single-node projection closure, JAX's `project_node`: (A, B, d, Qxx,
    Quu, Qux, qx, qu, C, D, g) of one node -> (A', B', d', Qxx', Quu', Qux',
    qx', qu', L, Z, w). `project_lq` on a node axis of 1: the projection's
    arithmetic is written once, there."""

    def one(A, B, d, Qxx, Quu, Qux, qx, qu, C, D, gv):
        lq = LQApprox(*(a[None] for a in (A, B, d, Qxx, Quu, Qux, qx, qu)), QN=None, qN=None)
        reduced, proj = project_lq(lq, C[None], D[None], gv[None], eps)
        return tuple(a[0] for a in (*reduced[:8], *proj))

    return one


def recover_controls(proj: ProjectionData, dxs: torch.Tensor, dzs: torch.Tensor) -> torch.Tensor:
    """du_k = L_k dx_k + Z_k dz_k + w_k."""
    return _mv(proj.L, dxs[..., :-1, :]) + _mv(proj.Z, dzs) + proj.w
