"""The LQ solve (backward Riccati + forward rollout), plain PyTorch.

A frozen copy of the port's plain version of K1 (`riccati_rollout_plain`):
`solver/riccati.py::backward_pass` (Cholesky) + `forward_pass`."""

from __future__ import annotations

import types

from mpcbench.reference.solver.riccati import backward_pass, forward_pass


def riccati_rollout(lq, dx0, reg: float = 1e-8, backend: str = "plain"):
    """(dxs, dus) of the damped LQ; `backend` is accepted for the solver's
    call and must be "plain"."""
    if backend != "plain":
        raise ValueError(f"the reference has only the plain LQ solve, not {backend!r}")
    stage = types.SimpleNamespace(A=lq.A, B=lq.B, d=lq.d, Qxx=lq.Qxx, Quu=lq.Quu, Qux=lq.Qux,
                                  qx=lq.qx, qu=lq.qu, QN=lq.QN, qN=lq.qN)
    return forward_pass(stage, backward_pass(stage, reg), dx0)
