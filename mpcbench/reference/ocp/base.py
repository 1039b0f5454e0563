"""OCP abstraction: each formulation exposes one per-node function

    node_terms(t, x, u, params) -> NodeTerms(r, h_log, h_log_mask, h_quad, g)

with cost 1/2 |r|^2 + sum relaxed_log_barrier(h_log) + sum quadratic_barrier(h_quad)
subject to g = 0. PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/base.py`.

Activity gating is row masking: inactive residual/equality rows are
multiplied to zero; inactive barrier rows are replaced by a benign constant so
value and derivatives vanish.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NodeTerms(NamedTuple):
    r: torch.Tensor           # Gauss-Newton residuals; cost += 0.5 |r|^2
    h_log: torch.Tensor       # relaxed-log-barrier rows (h >= 0 soft)
    h_log_mask: torch.Tensor  # 1.0 = row active; inactive rows contribute 0
    h_quad: torch.Tensor      # quadratic-barrier rows (h >= 0 soft)
    g: torch.Tensor           # equality-constraint residuals (hard)


class BarrierParams(NamedTuple):
    """Per-row penalty parameters, fixed at OCP construction."""
    log_mu: torch.Tensor
    log_delta: torch.Tensor
    quad_mu: torch.Tensor
    quad_delta: torch.Tensor


def masked_barrier_value(h, active, safe_value=1e3):
    """Replace inactive rows with a benign constant. `active` is float 0/1."""
    return active * h + (1.0 - active) * safe_value


def node_cost(terms: NodeTerms, bp: BarrierParams) -> torch.Tensor:
    """[...] cost of one node's terms: 1/2 |r|^2 + the active log-barrier rows
    + the quadratic-barrier rows (no equality term)."""
    from mpcbench.reference.ocp.penalties import quadratic_barrier, relaxed_log_barrier

    c = 0.5 * (terms.r ** 2).sum(-1)
    if terms.h_log.shape[-1]:
        c = c + (terms.h_log_mask
                 * relaxed_log_barrier(terms.h_log, bp.log_mu, bp.log_delta)).sum(-1)
    if terms.h_quad.shape[-1]:
        c = c + quadratic_barrier(terms.h_quad, bp.quad_mu, bp.quad_delta).sum(-1)
    return c
