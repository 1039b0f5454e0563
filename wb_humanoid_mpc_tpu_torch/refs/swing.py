"""The `SwingReference` container of `wb_humanoid_mpc_tpu/refs/swing.py`. The
swing planner that fills it is not ported yet; callers fill it with numpy
arrays (`convert.py`, the tests, `chip_smoke.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SwingReference:
    """Static-shape per-node reference arrays consumed by the OCP."""

    contact_flags: np.ndarray   # [N+1, 2] float (1.0 in contact)
    z_pos: np.ndarray           # [N+1, 2]
    z_vel: np.ndarray           # [N+1, 2]
    z_acc: np.ndarray           # [N+1, 2]
    proximity: np.ndarray       # [N+1, 2]
