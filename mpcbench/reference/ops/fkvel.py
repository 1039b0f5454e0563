"""The FK + velocity/bias tree pass, plain PyTorch.

A frozen copy of the port's plain version of K2: the level-parallel
`models/kinematics.py::forward_kinematics_vel` run on a batch."""

from __future__ import annotations

import torch

from mpcbench.reference.models.kinematics import FK, VelBias, forward_kinematics_vel
from mpcbench.reference.models.robot.urdf import RobotModel


def fkvel_batch(model: RobotModel, q: torch.Tensor, v: torch.Tensor,
                backend: str = "plain") -> tuple[FK, VelBias]:
    """q, v [B, nq] -> (FK, VelBias) with a leading B; `backend` must be
    "plain"."""
    if backend != "plain":
        raise ValueError(f"the reference has only the plain FK pass, not {backend!r}")
    return forward_kinematics_vel(model, q, v)
