"""Live gain re-tuning service.

Replaces `GainsReceiver` + the per-term `GainsUpdater*` family
(reference `gains/GainsReceiver.cpp:44`, headers in `gains/`): accepts gain
updates addressed to named terms (quadratic Q/R, terminal, foot cost weights,
barrier mu/delta for joint limits / collision / cone / moment) and applies
them to the live MPC.

The OCP reads its weights into tensors cached per (device, dtype) when the
solver first runs, so an update mutates the `TaskConfig` and swaps in a
solver rebuilt from it (the analogue of the reference's "update every
OptimalControlProblem copy" loop, `GainsReceiver.h:42-65`).

A numpy copy of `wb_humanoid_mpc_tpu/mpc/gains.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class GainUpdate:
    """One update message (the `/humanoid/mpc_gains` msg analogue)."""
    term: str            # e.g. "Q", "R", "Q_final", "foot_cost", "joint_limits",
    #                      "collision", "friction_cone", "contact_moment"
    values: np.ndarray | None = None   # diagonal / weight vector (term-dependent)
    mu: float | None = None            # barrier updates
    delta: float | None = None


class GainsService:
    def __init__(self, cfg, rebuild_solver: Callable[[], None]):
        """`rebuild_solver` rebuilds the solve function from the mutated cfg."""
        self.cfg = cfg
        self.rebuild_solver = rebuild_solver

    def apply(self, update: GainUpdate) -> None:
        c = self.cfg
        t = update.term
        if t == "Q" and update.values is not None:
            c.Q[:] = np.asarray(update.values)
        elif t == "R" and update.values is not None:
            c.R[:] = np.asarray(update.values)
        elif t == "Q_final" and update.values is not None:
            c.Q_final[:] = np.asarray(update.values)
        elif t == "foot_cost" and update.values is not None:
            c.task_space_foot_cost_weights[:] = np.asarray(update.values)
        elif t == "joint_limits":
            if update.mu is not None:
                c.joint_limits_barrier.mu = update.mu
            if update.delta is not None:
                c.joint_limits_barrier.delta = update.delta
        elif t == "collision":
            if update.mu is not None:
                c.collision.barrier.mu = update.mu
            if update.delta is not None:
                c.collision.barrier.delta = update.delta
        elif t == "friction_cone":
            if update.mu is not None:
                c.contacts.friction_cone_barrier.mu = update.mu
            if update.delta is not None:
                c.contacts.friction_cone_barrier.delta = update.delta
        elif t == "contact_moment":
            if update.mu is not None:
                c.contacts.contact_moment_barrier.mu = update.mu
            if update.delta is not None:
                c.contacts.contact_moment_barrier.delta = update.delta
        else:
            raise ValueError(f"unknown gain term: {t}")
        self.rebuild_solver()
