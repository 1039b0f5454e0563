"""Associative-scan (parallel-prefix) Riccati recursion: O(log N) depth.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/priccati.py` (the
parallel LQT formulation of Särkkä & García-Fernández, IEEE TAC 2021). Each
interval carries a conditional-value-function element e = (A, b, C, J, eta)
with the associative combination `_combine`; leaves come from the LQR stage
data after eliminating the control and the Qux cross term:

    K0 = -Quu^-1 Qux,  k0 = -Quu^-1 qu,
    leaf_k:        A = A + B K0, b = d + B k0, C = B Quu^-1 B^T,
                   J = Qxx + Qux^T K0, eta = -(qx + K0^T qu)
    terminal leaf: A = 0, b = 0, C = 0, J = QN, eta = -qN.

After a reversed inclusive scan, element k (combined k..N) gives
P_k = J_k and p_k = -eta_k, and the gains follow node by node, all at once.

PyTorch has no `associative_scan`: `_scan` is a Hillis–Steele scan written
here, ceil(log2(N+1)) rounds of the batched combination over the node axis
(axis 0). JAX combines in another tree, so the two agree to roundoff, not bit
for bit; both agree with the sequential `backward_pass`. This runs in plain
PyTorch on the card as the JAX version runs in XLA on the TPU: no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wb_humanoid_mpc_tpu_torch.solver.riccati import RiccatiSolution, cholesky


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    J: torch.Tensor
    eta: torch.Tensor


def _T(M):
    return M.transpose(-1, -2)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _solve(A, B):
    """A^-1 B by LU, without the error check: a singular A gives inf/NaN, as
    `jnp.linalg.solve` does, instead of raising (and syncing with the host)."""
    return torch.linalg.solve_ex(A, B, check_errors=False).result


def _combine(ej: _Elem, ei: _Elem) -> _Elem:
    """Combine e_i (earlier) with e_j (later): value-function composition,
    batched over any leading dims."""
    Ai, bi, Ci, Ji, etai = ei
    Aj, bj, Cj, Jj, etaj = ej
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    # A_j (I + C_i J_j)^-1, by a solve with the transposed system
    AjM = _T(_solve(_T(eye + Ci @ Jj), _T(Aj)))
    A = AjM @ Ai
    b = _mv(AjM, bi + _mv(Ci, etaj)) + bj
    C = AjM @ Ci @ _T(Aj) + Cj
    M2 = eye + Jj @ Ci
    tmp = _T(Ai) @ _solve(M2, eye.expand(M2.shape))   # A_i^T (I + J_j C_i)^-1
    J = tmp @ Jj @ Ai + Ji
    eta = _mv(tmp, etaj - _mv(Jj, bi)) + etai
    return _Elem(A, b, C, J, eta)


def _scan(fn, elems, reverse: bool):
    """Inclusive scan of the associative `fn(later, earlier)` over axis 0 of
    every field of the NamedTuple `elems`, in ceil(log2(n)) batched rounds
    (Hillis–Steele). Forward: out[k] = e_0..e_k; reverse: out[k] = e_k..e_{n-1}."""
    kind = type(elems)
    n = elems[0].shape[0]
    cur, off = elems, 1
    while off < n:
        # pair k: the block that starts at k + off (later) with the one at k
        merged = fn(kind(*(a[off:] for a in cur)), kind(*(a[:-off] for a in cur)))
        if reverse:   # element k absorbs the later block; the last `off` stay
            cur = kind(*(torch.cat([m, a[n - off:]]) for m, a in zip(merged, cur)))
        else:         # element k + off absorbs the earlier block; the first `off` stay
            cur = kind(*(torch.cat([a[:off], m]) for m, a in zip(merged, cur)))
        off *= 2
    return cur


def stage_leaf(A, B, d, Qxx, Quu, Qux, qx, qu, reg: float) -> _Elem:
    """Scan element of LQR stages (leading dims allowed) after eliminating the
    control and the Qux cross term."""
    nu = B.shape[-1]
    eyeu = torch.eye(nu, dtype=B.dtype, device=B.device)
    scale = torch.clamp(torch.amax(torch.diagonal(Quu, dim1=-2, dim2=-1), dim=-1), min=1.0)
    Quu_r = Quu + (reg * scale)[..., None, None] * eyeu
    L = cholesky(0.5 * (Quu_r + _T(Quu_r)))
    K0 = -torch.cholesky_solve(Qux, L)
    k0 = -torch.cholesky_solve(qu[..., None], L)[..., 0]
    BiQ = torch.cholesky_solve(_T(B), L)
    C = B @ BiQ
    J = Qxx + _T(Qux) @ K0
    return _Elem(A + B @ K0, d + _mv(B, k0), 0.5 * (C + _T(C)), 0.5 * (J + _T(J)),
                 -(qx + _mv(_T(K0), qu)))


def _leaves(lq, reg: float) -> _Elem:
    stage = stage_leaf(lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu, reg)
    QN, qN = lq.QN[None], lq.qN[None]
    term = _Elem(A=torch.zeros_like(QN), b=torch.zeros_like(qN), C=torch.zeros_like(QN), J=QN,
                 eta=-qN)
    return _Elem(*(torch.cat([s, t]) for s, t in zip(stage, term)))


def parallel_backward_pass(lq, reg: float = 1e-8) -> RiccatiSolution:
    """Stage data [N, ...] -> (K, k, P, p) of the sequential `backward_pass`.
    A batch of instances goes behind the node axis: stage data [N, *batch,
    ...], QN and qN [*batch, ...]."""
    comb = _scan(_combine, _leaves(lq, reg), reverse=True)
    P = 0.5 * (comb.J + _T(comb.J))   # [N+1, nx, nx]
    p = -comb.eta                      # [N+1, nx]
    P1, p1 = P[1:], p[1:]
    B = lq.B
    eyeu = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    Quu_h = lq.Quu + _T(B) @ P1 @ B
    scale = torch.clamp(torch.amax(torch.diagonal(Quu_h, dim1=-2, dim2=-1), dim=-1), min=1.0)
    Quu_h = Quu_h + (reg * scale)[..., None, None] * eyeu
    Qux_h = lq.Qux + _T(B) @ P1 @ lq.A
    Qu = lq.qu + _mv(_T(B), _mv(P1, lq.d) + p1)
    L = cholesky(0.5 * (Quu_h + _T(Quu_h)))
    K = -torch.cholesky_solve(Qux_h, L)
    k = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
    return RiccatiSolution(K=K, k=k, P=P, p=p)


class _Affine(NamedTuple):
    F: torch.Tensor
    f: torch.Tensor


def _affine(b: _Affine, a: _Affine) -> _Affine:
    """The affine map b after a."""
    return _Affine(b.F @ a.F, _mv(b.F, a.f) + b.f)


def parallel_forward_pass(lq, sol: RiccatiSolution, dx0):
    """Closed-loop linear rollout as an associative affine scan (O(log N)):
    (dxs [N+1, nx], dus [N, nu])."""
    F = lq.A + lq.B @ sol.K
    f = lq.d + _mv(lq.B, sol.k)
    Fs, fs = _scan(_affine, _Affine(F, f), reverse=False)
    dxs = torch.cat([dx0[None], _mv(Fs, dx0) + fs])
    dus = _mv(sol.K, dxs[:-1]) + sol.k
    return dxs, dus
