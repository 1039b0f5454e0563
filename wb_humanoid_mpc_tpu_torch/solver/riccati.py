"""Riccati backward/forward passes for the multiple-shooting LQ subproblem.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/riccati.py`; together
`backward_pass` and `forward_pass` are the plain version of the CUDA
Riccati kernel (`ops/riccati.py`). The JAX `lax.scan` becomes a Python loop
over the stages; a leading batch of problem instances rides along.

Convention (dx_k = x_k deviation, du_k = u_k deviation):
    dynamics   dx_{k+1} = A_k dx_k + B_k du_k + d_k       (d = shooting defect)
    stage cost 1/2 dx'Qxx dx + 1/2 du'Quu du + du'Qux dx + qx'dx + qu'du
    terminal   1/2 dx'QN dx + qN'dx
Outputs feedback gains K_k, feedforward k_k with du = K dx + k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def cholesky(M):
    """Lower Cholesky factor of a symmetric M, with NaN in its lower triangle
    where M is not positive definite: `jnp.linalg.cholesky`'s answer there.
    A failed factorization then reaches the cost as NaN, which the runtime's
    divergence recovery handles as the JAX package's does, where
    `torch.linalg.cholesky` would raise."""
    L, info = torch.linalg.cholesky_ex(M)
    nan = torch.full_like(L, float("nan")).tril()
    return torch.where((info > 0)[..., None, None], nan, L)


def levenberg_damp(lq, reg: float):
    """Fold relative Levenberg trust-region damping into the stage data:
    Quu_k += reg * max(max(diag(Quu_k)), 1) * I."""
    nu = lq.Quu.shape[-1]
    diag = torch.diagonal(lq.Quu, dim1=-2, dim2=-1)
    scale = torch.clamp(torch.amax(diag, dim=-1), min=1.0)
    eyeu = torch.eye(nu, dtype=lq.Quu.dtype, device=lq.Quu.device)
    return lq._replace(Quu=lq.Quu + (reg * scale)[..., None, None] * eyeu)


class RiccatiSolution(NamedTuple):
    K: torch.Tensor   # [..., N, nu, nx]
    k: torch.Tensor   # [..., N, nu]
    P: torch.Tensor   # [..., N+1, nx, nx]  value Hessians (P_N = QN)
    p: torch.Tensor   # [..., N+1, nx]      value gradients (p_N = qN)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def backward_pass(lq, reg: float = 1e-8) -> RiccatiSolution:
    """Stage data with leading dims [..., N, ...]; QN [..., nx, nx]."""
    N = lq.A.shape[-3]
    nu = lq.B.shape[-1]
    eyeu = torch.eye(nu, dtype=lq.B.dtype, device=lq.B.device)
    P, p = lq.QN, lq.qN
    Ks, ks = [None] * N, [None] * N
    Ps, ps = [None] * N + [P], [None] * N + [p]
    for i in reversed(range(N)):
        A, B, d = lq.A[..., i, :, :], lq.B[..., i, :, :], lq.d[..., i, :]
        At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
        Pd_p = _mv(P, d) + p
        Qx = lq.qx[..., i, :] + _mv(At, Pd_p)
        Qu = lq.qu[..., i, :] + _mv(Bt, Pd_p)
        PA = P @ A
        PB = P @ B
        Qxx_h = lq.Qxx[..., i, :, :] + At @ PA
        Quu_h = lq.Quu[..., i, :, :] + Bt @ PB
        # relative Levenberg regularization keeps the Cholesky PD in float32
        scale = torch.clamp(torch.amax(torch.diagonal(Quu_h, dim1=-2, dim2=-1), dim=-1), min=1.0)
        Quu_h = Quu_h + (reg * scale)[..., None, None] * eyeu
        Qux_h = lq.Qux[..., i, :, :] + Bt @ PA
        L = cholesky(0.5 * (Quu_h + Quu_h.transpose(-1, -2)))
        K = -torch.cholesky_solve(Qux_h, L)
        kff = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
        P = Qxx_h + Qux_h.transpose(-1, -2) @ K
        P = 0.5 * (P + P.transpose(-1, -2))
        p = Qx + _mv(Qux_h.transpose(-1, -2), kff)
        Ks[i], ks[i], Ps[i], ps[i] = K, kff, P, p
    return RiccatiSolution(K=torch.stack(Ks, dim=-3), k=torch.stack(ks, dim=-2),
                           P=torch.stack(Ps, dim=-3), p=torch.stack(ps, dim=-2))


def forward_pass(lq, sol: RiccatiSolution, dx0) -> tuple[torch.Tensor, torch.Tensor]:
    """Roll the linear closed loop; returns (dxs [..., N+1, nx], dus [..., N, nu])."""
    N = lq.A.shape[-3]
    dx = dx0
    dxs, dus = [dx0], []
    for i in range(N):
        du = _mv(sol.K[..., i, :, :], dx) + sol.k[..., i, :]
        dx = _mv(lq.A[..., i, :, :], dx) + _mv(lq.B[..., i, :, :], du) + lq.d[..., i, :]
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)
