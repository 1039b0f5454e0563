"""Penalty functions for soft inequality constraints (elementwise).

PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/penalties.py`: ocs2's
`RelaxedBarrierPenalty` with a bounded far-field tail, and a C1
piecewise-quadratic hinge. The analytic first and second
derivatives are what the Gauss-Newton assembly uses.
"""

from __future__ import annotations

import torch

# Bounded-tail switch for the relaxed log barrier, at h_cap = RATIO * delta
# (see the JAX module for why the pure -mu*ln(h) tail is not used).
LOG_BARRIER_CAP_RATIO = 3.0


def relaxed_log_barrier(h, mu, delta):
    """p(h) = mu (-ln delta + 1/2 ((h - 2 delta)/delta)^2 - 1/2)   h <= delta
       p(h) = -mu ln h                                 delta < h <= cap delta
       p(h) = -mu (ln h_cap + 1 - h_cap / h)           h > h_cap"""
    h_cap = LOG_BARRIER_CAP_RATIO * delta
    h_mid = torch.minimum(torch.maximum(h, delta), h_cap)
    log_branch = -mu * torch.log(h_mid)
    z = (h - 2.0 * delta) / delta
    quad_branch = mu * (-torch.log(delta) + 0.5 * z * z - 0.5)
    tail_branch = -mu * (torch.log(h_cap) + 1.0 - h_cap / torch.maximum(h, h_cap))
    return torch.where(h > h_cap, tail_branch, torch.where(h > delta, log_branch, quad_branch))


def quadratic_barrier(h, mu, delta):
    """p(h) = (mu/2) ((h - delta)/delta)^2 for h < delta, else 0."""
    z = torch.clamp(h - delta, max=0.0) / delta
    return 0.5 * mu * z * z


def relaxed_log_barrier_d1(h, mu, delta):
    h_cap = LOG_BARRIER_CAP_RATIO * delta
    h_mid = torch.minimum(torch.maximum(h, delta), h_cap)
    log_branch = -mu / h_mid
    quad_branch = mu * (h - 2.0 * delta) / (delta * delta)
    h_tail = torch.maximum(h, h_cap)
    tail_branch = -mu * h_cap / (h_tail * h_tail)
    return torch.where(h > h_cap, tail_branch, torch.where(h > delta, log_branch, quad_branch))


def relaxed_log_barrier_d2(h, mu, delta):
    h_cap = LOG_BARRIER_CAP_RATIO * delta
    h_mid = torch.minimum(torch.maximum(h, delta), h_cap)
    log_branch = mu / (h_mid * h_mid)
    quad_branch = (mu / (delta * delta)).expand_as(h)
    h_tail = torch.maximum(h, h_cap)
    tail_branch = 2.0 * mu * h_cap / (h_tail * h_tail * h_tail)
    return torch.where(h > h_cap, tail_branch, torch.where(h > delta, log_branch, quad_branch))


def quadratic_barrier_d1(h, mu, delta):
    z = torch.clamp(h - delta, max=0.0) / delta
    return mu * z / delta


def quadratic_barrier_d2(h, mu, delta):
    active = (h < delta).to(h.dtype)
    return mu * active / (delta * delta)
