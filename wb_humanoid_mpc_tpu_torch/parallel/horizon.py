"""Horizon-block distributed Riccati: the horizon sharded over ranks.

PyTorch counterpart of `wb_humanoid_mpc_tpu/parallel/horizon.py`. The
backward Riccati recursion and the forward closed-loop rollout are
associative scans (`solver/priccati.py`), so they run across ranks as a
two-level prefix scan:

  1. each rank owns a contiguous block of K horizon elements and runs the
     local scan (`priccati._scan`);
  2. the per-block summary elements (a whole block combined) are gathered
     over the group: n_ranks elements of [nx, nx] matrices;
  3. every rank combines the summaries into its block's suffix (backward) or
     prefix (forward) element and applies it to its local results.

One `all_gather` per pass, plus one shift-by-one for the value function of
the element after each block (`parallel/collectives.py`). The five fields
of an element travel packed in one tensor.

The block functions take the node axis first, as `priccati._scan` does, and
any batch of instances behind it. Each is its local parts (`value_scan`,
`value_functions`, `next_values`, `feedback_gains`, `rollout_scan`,
`rollout_prefix`) with the collectives between them; the 2-D sharded SQP
(`solver/sharded_sqp.py`) calls the parts itself, so that its CUDA graphs
can cut at every collective. `horizon_sharded_lq_solve` wraps the block
functions for one LQ problem. Results match the sequential `solver/riccati.py` passes
to float tolerance (tests/test_torch_horizon.py).
"""

from __future__ import annotations

import torch

from wb_humanoid_mpc_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    next_block,
    pack,
    unpack,
)
from wb_humanoid_mpc_tpu_torch.solver.priccati import (
    _Affine,
    _affine,
    _combine,
    _Elem,
    _leaves,
    _scan,
)
from wb_humanoid_mpc_tpu_torch.solver.riccati import cholesky
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _identity_elem(n: int, lead: tuple, dtype, device) -> _Elem:
    """Identity elements of the value-function composition, leading dims `lead`."""
    eye = torch.eye(n, dtype=dtype, device=device).expand(*lead, n, n)
    zM = torch.zeros(*lead, n, n, dtype=dtype, device=device)
    zv = torch.zeros(*lead, n, dtype=dtype, device=device)
    return _Elem(A=eye, b=zv, C=zM, J=zM, eta=zv)


def _affine_identity(n: int, lead: tuple, dtype, device) -> _Affine:
    eye = torch.eye(n, dtype=dtype, device=device).expand(*lead, n, n)
    return _Affine(eye, torch.zeros(*lead, n, dtype=dtype, device=device))


def _affine_combine(a: _Affine, b: _Affine) -> _Affine:
    """(F_b, f_b) after (F_a, f_a): the forward-rollout composition in JAX's
    argument order (`priccati._affine` takes the later map first)."""
    return _affine(b, a)


def rows_out(elem, rows: slice) -> torch.Tensor:
    """Each field's `rows`, packed into one tensor [n, total]: what a block
    sends to the gather of the per-block summaries."""
    return pack([a[rows] for a in elem], 1)[0]


def rows_in(gathered: torch.Tensor, like):
    """The gathered rows, unpacked into fields shaped like `like`'s."""
    return type(like)(*unpack(gathered, [a.shape[1:] for a in like], 1))


def _gather_rows(elem, rows: slice, group):
    """Every rank's `rows` of each field, gathered along dim 0 (one collective)."""
    return rows_in(all_gather(rows_out(elem, rows), group), elem)


# The block passes below are the local parts of the distributed scans and
# the collectives between them. The sharded SQP (`solver/sharded_sqp.py`)
# calls the parts itself, so that its CUDA graphs can cut at each collective.

def value_scan(elems_loc: _Elem) -> _Elem:
    """The local reversed scan of the block's elements [K, ...]; its first
    row combines the whole block (`rows_out(loc, slice(0, 1))` is what the
    block sends)."""
    return _scan(_combine, elems_loc, reverse=True)


def value_functions(loc: _Elem, sums: _Elem, i_dev: int):
    """(P, p) [K, ...] of the block's elements, from the local scan and
    every block's summary element (`sums`, [n_dev, ...] fields, gathered)."""
    nx = loc.A.shape[-1]
    lead = loc.A.shape[1:-2]
    # T_i = combine(blocks i..P-1); suffix S_i = T_{i+1} (identity for the last)
    T = _scan(_combine, sums, reverse=True)
    T_pad = _Elem(*(torch.cat([a, i]) for a, i in
                    zip(T, _identity_elem(nx, (1, *lead), T.A.dtype, T.A.device))))
    suffix = _Elem(*(a[i_dev + 1][None] for a in T_pad))
    comb = _combine(suffix, loc)
    P_loc = 0.5 * (comb.J + comb.J.transpose(-1, -2))               # [K, ..., nx, nx]
    p_loc = -comb.eta                                                # [K, ..., nx]
    return P_loc, p_loc


def first_values(P_loc, p_loc) -> torch.Tensor:
    """(P, p) of the block's first element, packed: what the previous block
    needs for its last."""
    return pack([P_loc[0], p_loc[0]], P_loc.dim() - 3)[0]


def next_values(P_loc, p_loc, first_next):
    """(P, p) of element k+1: shift by one, the last row from the next
    block's `first_values` (`first_next`)."""
    P_first, p_first = unpack(first_next, [P_loc.shape[-2:], p_loc.shape[-1:]],
                              P_loc.dim() - 3)
    return torch.cat([P_loc[1:], P_first[None]]), torch.cat([p_loc[1:], p_first[None]])


def block_value_functions(elems_loc: _Elem, group):
    """Distributed reversed scan: local elements [K, ...] -> (P, p) [K, ...]
    plus (P_next, p_next) of element k+1 (the next block's first row for the
    last local one)."""
    loc = value_scan(elems_loc)
    P_loc, p_loc = value_functions(loc, _gather_rows(loc, slice(0, 1), group),
                                   axis_index(group))
    P_next, p_next = next_values(P_loc, p_loc, next_block(first_values(P_loc, p_loc), group))
    return P_loc, p_loc, P_next, p_next


def feedback_gains(Pn, pn, A, B, d, Quu, Qux, qu, reg: float):
    """The feedback gains (K, k_ff) of the local nodes, from the value
    function of the node after each (Pn, pn)."""
    nu = B.shape[-1]
    eyeu = torch.eye(nu, dtype=B.dtype, device=B.device)
    Bt = B.transpose(-1, -2)
    Quu_h = Quu + Bt @ Pn @ B
    scale = torch.clamp(torch.amax(torch.diagonal(Quu_h, dim1=-2, dim2=-1), dim=-1), min=1.0)
    Quu_h = Quu_h + (reg * scale)[..., None, None] * eyeu
    Qux_h = Qux + Bt @ Pn @ A
    Qu = qu + _mv(Bt, _mv(Pn, d) + pn)
    L = cholesky(0.5 * (Quu_h + Quu_h.transpose(-1, -2)))
    Kg = -torch.cholesky_solve(Qux_h, L)
    kg = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
    return Kg, kg


def block_backward_gains(elems_loc: _Elem, A, B, d, Qxx, Quu, Qux, qx, qu, group, reg: float):
    """Distributed backward pass: the feedback gains (K, k_ff) of the local
    nodes. Stage arrays are the block's [K, ...] rows."""
    _, _, Pn, pn = block_value_functions(elems_loc, group)
    return feedback_gains(Pn, pn, A, B, d, Quu, Qux, qu, reg)


def rollout_scan(F, f) -> _Affine:
    """The local prefix scan of the block's links (F, f) [K, ..., nx(, nx)];
    its last row composes the whole block (`rows_out(loc, slice(-1, None))`
    is what the block sends)."""
    return _scan(_affine, _Affine(F, f), reverse=False)


def rollout_prefix(locF: _Affine, sumsF: _Affine, i_dev: int, dx0):
    """(dx at each local node, dx at the node after each), from the local
    scan, every block's summary link (`sumsF`, gathered) and the replicated
    dx0 [..., nx]."""
    nx = locF.F.shape[-1]
    lead = locF.F.shape[1:-2]
    Tf = _scan(_affine, sumsF, reverse=False)
    eyeI = _affine_identity(nx, (1, *lead), locF.F.dtype, locF.F.device)
    Tf_pad = _Affine(*(torch.cat([i, a]) for i, a in zip(eyeI, Tf)))
    prefix = _Affine(*(a[i_dev][None] for a in Tf_pad))   # all blocks before mine
    Fg, fg = _affine_combine(prefix, locF)
    dx_next = _mv(Fg, dx0) + fg                            # dx_{k+1} per local row
    dx_first = _mv(prefix.F, dx0) + prefix.f               # dx at the block's start
    return torch.cat([dx_first, dx_next[:-1]]), dx_next


def block_forward_rollout(F, f, dx0, group):
    """Distributed affine prefix scan: local links (F, f) [K, ..., nx(, nx)]
    and the replicated dx0 [..., nx] -> (dx at each local node, dx at the
    node after each): dx_k for the block's global node indices."""
    locF = rollout_scan(F, f)
    return rollout_prefix(locF, _gather_rows(locF, slice(-1, None), group), axis_index(group),
                          dx0)


def horizon_sharded_lq_solve(lq, dx0, mesh, axis: str = "h", reg: float = 1e-8, *,
                             device="cuda"):
    """Backward + forward Riccati of one LQ problem, the horizon sharded over
    the ranks of `mesh` along `axis`.

    Every rank passes the whole problem (stage data [N, ...], QN, qN, dx0)
    on `device` and gets the whole (dxs [N+1, nx], dus [N, nu]) back, equal
    to `backward_pass` + `forward_pass`."""
    dev = resolve_device(device)
    if lq.A.device != dev or dx0.device != dev:
        raise ValueError(f"solve on {dev}, got tensors on {lq.A.device}")
    group = mesh.group(axis)
    n_dev, i_dev = mesh.shape[axis], mesh.index(axis)
    N, nx = lq.A.shape[0], lq.A.shape[1]
    M = N + 1                      # scan elements incl. terminal
    K = -(-M // n_dev)             # block size (ceil)
    pad = K * n_dev - M
    dtype = lq.A.dtype

    elems = _leaves(lq, reg)       # [M, ...]
    if pad:
        elems = _Elem(*(torch.cat([a, i]) for a, i in
                        zip(elems, _identity_elem(nx, (pad,), dtype, dev))))

    # stage data padded with zero rows to K * n_dev for uniform blocks
    def pad_stage(a):
        z = torch.zeros(K * n_dev - N, *a.shape[1:], dtype=a.dtype, device=a.device)
        return torch.cat([a, z])

    rows = slice(i_dev * K, (i_dev + 1) * K)
    A, B, d, Qxx, Quu, Qux, qx, qu = (pad_stage(a)[rows] for a in
                                      (lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu))
    Kg, kg = block_backward_gains(_Elem(*(a[rows] for a in elems)), A, B, d, Qxx, Quu, Qux,
                                  qx, qu, group, reg)
    F = A + B @ Kg
    f = d + _mv(B, kg)
    # padded stage rows must act as identity links
    valid = torch.arange(i_dev * K, (i_dev + 1) * K, device=dev) < N
    F = torch.where(valid[:, None, None], F, torch.eye(nx, dtype=dtype, device=dev))
    f = torch.where(valid[:, None], f, torch.zeros_like(f))
    dx_here, _ = block_forward_rollout(F, f, dx0, group)
    du = _mv(Kg, dx_here) + kg
    flat, tails = pack([dx_here, du], 1)
    dxs, dus = unpack(all_gather(flat, group), tails, 1)
    return dxs[:M], dus[:N]
