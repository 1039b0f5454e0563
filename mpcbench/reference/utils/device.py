"""Device selection for the reference: a torch.device, nothing set."""

from __future__ import annotations

import torch


def resolve_device(device="cpu") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
