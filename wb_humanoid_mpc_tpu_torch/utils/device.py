"""Device selection for the port's entry points.

Entry points default to the CUDA card and never fall back to the CPU: a
caller who wants the CPU (the tests) passes `device="cpu"`. On the card,
float32 matrix products must run in full float32 (the JAX package sets
`jax_default_matmul_precision="highest"` for the same reason): TF32 keeps
about three decimal digits and would break every float32 tolerance.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; for CUDA, check a card exists and turn TF32 off."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("could not turn TF32 matrix products off")
        if dev.index is None:   # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
