"""Filter line-search acceptance rule (ocs2's `FilterLinesearch`).

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/linesearch.py`. With
baseline performance (c0, v0) and candidate performance (cs, vs), where
v = sqrt(SSE(equalities) + SSE(shooting defects)):

  vs > g_max             -> accept only a violation decrease;
  max(vs, v0) < g_min    -> accept on cost decrease;
  otherwise              -> accept if the cost decreases (beyond a
                            violation-proportional margin) or the violation
                            decreases.
"""

from __future__ import annotations

import torch

GAMMA = 1e-6  # relative-decrease factor (ocs2 gamma_c)


def filter_accept(c0, v0, cs, vs, g_max: float, g_min: float, gamma: float = GAMMA):
    """Acceptance mask over the candidates in cs/vs; non-finite candidates
    are rejected."""
    viol_decreased = vs < (1.0 - gamma) * v0
    high = vs > g_max
    low = torch.maximum(vs, v0) < g_min
    accept = torch.where(high, viol_decreased,
                         torch.where(low, cs < c0, (cs < c0 - gamma * vs) | viol_decreased))
    return accept & torch.isfinite(cs) & torch.isfinite(vs)
