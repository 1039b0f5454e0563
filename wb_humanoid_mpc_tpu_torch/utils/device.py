"""Device selection for the port's entry points.

Entry points default to the CUDA card and never fall back to the CPU: a
caller who wants the CPU (the tests) passes `device="cpu"`. On the card,
float32 matrix products must run in full float32 (the JAX package sets
`jax_default_matmul_precision="highest"` for the same reason): TF32 keeps
about three decimal digits and would break every float32 tolerance. The
batched factorizations and solves go to cuSOLVER / cuBLAS, not MAGMA:
MAGMA's batched routines (`cholesky_solve`'s `magma_spotrs_batched`, the
batched LU of `linalg.solve_ex`) call the runtime in ways a CUDA graph
capture refuses, and the solve runs as CUDA graphs (`solver/graphs.py`).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; for CUDA, check a card exists, turn TF32
    off and prefer cuSOLVER to MAGMA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("could not turn TF32 matrix products off")
        torch.backends.cuda.preferred_linalg_library("cusolver")
        if dev.index is None:   # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
