"""K3: the closed-loop linear forward rollout of the LQ subproblem in one CUDA
kernel launch, given the Riccati gains.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ops/rollout.py`. The kernel
(`csrc/rollout.cu`, one thread-block cluster per problem instance, each CTA
holding a range of stages in its shared memory and handing dx to the next)
replaces the Pallas TPU kernel `_rollout_kernel`; its plain version is the ported
`solver/riccati.py::forward_pass`. Together with the sequential
`backward_pass` it makes the split LQ solve, the unfused alternative to K1
(`ops/riccati.py`).

`forward_rollout_cuda` / `forward_rollout_plain` take (A, B, d, K, k, dx0)
with an optional leading batch of instances and return (dxs [.., N+1, nx],
dus [.., N, nu]). `rollout_plan` gives the launch geometry the kernel takes
for a shape (cluster size, stage slots per CTA, shared bytes per CTA, how
many such clusters the card holds at once, threads per CTA);
`forward_rollout_cuda` raises if that last is 0. A wait inside the kernel
that outlasts 10 s (a fault of the kernel, never a slow card) traps, and the
process's CUDA context is unusable afterwards.
Dispatch, `forward_rollout(lq, sol, dx0, backend)`:
  "auto"  — the kernel for CUDA tensors, the plain version for CPU tensors;
  "cuda"  — the kernel (raises for tensors that are not on a CUDA device);
  "plain" — the plain version on any device (to hold the kernel against it).
The JAX package's names are accepted too: "pallas" is "cuda", "scan" is
"plain". There is no interpret mode.
"""

from __future__ import annotations

import ctypes
import types

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib
from wb_humanoid_mpc_tpu_torch.solver.riccati import forward_pass

_lib.register_counter(__name__)   # LAUNCHES and RECORDED (`ops/_lib.py`)

_FIELDS = ("A", "B", "d", "K", "k", "dx0")
_ALIASES = {"pallas": "cuda", "scan": "plain"}


def reset_launches() -> None:
    _lib.reset_launches(__name__)


def forward_rollout_plain(A, B, d, K, k, dx0):
    """Plain PyTorch version: (dxs [.., N+1, nx], dus [.., N, nu])."""
    return forward_pass(types.SimpleNamespace(A=A, B=B, d=d), types.SimpleNamespace(K=K, k=k),
                        dx0)


_PLANS: dict = {}


def rollout_plan(N: int, nx: int, nu: int, dtype: torch.dtype) -> dict:
    """The kernel's launch geometry for one instance of a shape: cluster size,
    stage slots per CTA, shared bytes per CTA, `cudaOccupancyMaxActiveClusters`
    and threads per CTA.
    Raises if the shape does not fit or the card cannot hold one such cluster."""
    key = (N, nx, nu, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _lib.library()
        out = (ctypes.c_int * 5)()
        itemsize = 4 if dtype == torch.float32 else 8
        code = lib.wbmpc_forward_rollout_plan(N, nx, nu, itemsize, out)
        _lib.check(lib, code, f"forward rollout plan for (N, nx, nu) = ({N}, {nx}, {nu})")
        plan = dict(cluster=out[0], slots=out[1], smem_bytes=out[2], max_active_clusters=out[3],
                    threads=out[4])
        if plan["max_active_clusters"] < 1:
            raise RuntimeError(f"forward rollout: the card cannot schedule a cluster of "
                               f"{plan['cluster']} CTAs with {plan['smem_bytes']} shared "
                               f"bytes each")
        _PLANS[key] = plan
    return plan


def forward_rollout_cuda(A, B, d, K, k, dx0):
    """Launch the kernel on the current stream; same contract as the plain version."""
    args = dict(zip(_FIELDS, (A, B, d, K, k, dx0)))
    dev, dtype = A.device, A.dtype
    if not A.is_cuda or any(a.device != dev for a in args.values()):
        raise ValueError("forward_rollout_cuda needs every input on one CUDA device")
    if dtype not in (torch.float32, torch.float64) or any(a.dtype != dtype for a in args.values()):
        raise ValueError("forward_rollout_cuda takes float32 or float64 inputs of one dtype")
    N, nx, nu = A.shape[-3], A.shape[-1], B.shape[-1]
    lead = tuple(A.shape[:-3])
    want = {"A": (N, nx, nx), "B": (N, nx, nu), "d": (N, nx), "K": (N, nu, nx), "k": (N, nu),
            "dx0": (nx,)}
    for name, a in args.items():
        if tuple(a.shape) != lead + want[name]:
            raise ValueError(f"forward_rollout_cuda: {name} has shape {tuple(a.shape)}, "
                             f"expected {lead + want[name]}")
    batch = 1
    for s in lead:
        batch *= int(s)
    ins = [a.contiguous() for a in args.values()]
    dxs = torch.empty(*lead, N + 1, nx, dtype=dtype, device=dev)
    dus = torch.empty(*lead, N, nu, dtype=dtype, device=dev)
    rollout_plan(N, nx, nu, dtype)
    lib = _lib.library()
    fn = (lib.wbmpc_forward_rollout_f32 if dtype == torch.float32
          else lib.wbmpc_forward_rollout_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(a.data_ptr() for a in ins), dxs.data_ptr(), dus.data_ptr(), batch, N, nx, nu,
              stream)
    _lib.check(lib, code, "forward rollout kernel")
    _lib.count_launch(__name__)
    return dxs, dus


def random_stage_data(rng, N=28, nx=58, nu=35, dtype=np.float32) -> dict:
    """Random closed-loop stage data (near-identity A, small gains) as numpy
    arrays keyed like `forward_rollout_*`'s arguments: the generator of
    `tests/test_ops_rollout.py::_stage_data`, for the tests and the kernel
    harness (`chip_smoke.py`)."""
    A = np.tile(np.eye(nx, dtype=dtype)[None], (N, 1, 1)) \
        + rng.normal(size=(N, nx, nx)).astype(dtype) * 0.005
    B = rng.normal(size=(N, nx, nu)).astype(dtype) * 0.02
    d = rng.normal(size=(N, nx)).astype(dtype) * 0.01
    K = rng.normal(size=(N, nu, nx)).astype(dtype) * 0.05
    k = rng.normal(size=(N, nu)).astype(dtype) * 0.01
    dx0 = rng.normal(size=(nx,)).astype(dtype)
    return dict(A=A, B=B, d=d, K=K, k=k, dx0=dx0)


def forward_rollout(lq, sol, dx0, backend: str = "auto"):
    """Drop-in for `solver/riccati.py::forward_pass`: (dxs, dus)."""
    backend = _ALIASES.get(backend, backend)
    if backend == "auto":
        backend = "cuda" if lq.A.is_cuda else "plain"
    if backend == "plain":
        return forward_pass(lq, sol, dx0)
    if backend == "cuda":
        return forward_rollout_cuda(lq.A, lq.B, lq.d, sol.K, sol.k, dx0)
    raise ValueError(f"unknown rollout backend {backend!r}")
