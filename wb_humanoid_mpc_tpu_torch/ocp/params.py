"""Node-parameter helpers. PyTorch counterpart of `weight_comp_input` in
`wb_humanoid_mpc_tpu/ocp/params.py`; the centroidal params builder waits for
the centroidal formulation."""

from __future__ import annotations

import torch


def weight_comp_input(total_mass: float, gravity: float, contact_flags: torch.Tensor,
                      input_dim: int) -> torch.Tensor:
    """Nominal input: gravity-compensating stance forces split over the feet in
    contact (contact_flags [..., 2] -> u [..., input_dim], same dtype/device)."""
    n_stance = torch.clamp(contact_flags.sum(-1, keepdim=True), min=1.0)
    fz = total_mass * gravity / n_stance * contact_flags
    zeros = torch.zeros(*contact_flags.shape[:-1], 1, dtype=fz.dtype, device=fz.device)
    rest = torch.zeros(*contact_flags.shape[:-1], input_dim - 9, dtype=fz.dtype,
                       device=fz.device)
    return torch.cat([zeros, zeros, fz[..., 0:1], zeros, zeros, zeros,
                      zeros, zeros, fz[..., 1:2], rest], dim=-1)
