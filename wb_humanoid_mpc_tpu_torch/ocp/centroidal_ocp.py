"""The two pieces of `wb_humanoid_mpc_tpu/ocp/centroidal_ocp.py` that the
whole-body OCP uses. The centroidal formulation itself is not ported yet."""

from __future__ import annotations

import torch

from wb_humanoid_mpc_tpu_torch.utils.rotations import cross

FRICTION_REGULARIZATION = 25.0  # reference FrictionForceConeConstraint.h:66-67 default


def _tilt_error(R, normal):
    """3-dim orientation-vs-plane error n x (R e_z): zero iff the frame z-axis
    aligns with the plane normal. R [..., 3, 3], normal [3]."""
    return cross(normal.expand_as(R[..., :, 2]), R[..., :, 2])
