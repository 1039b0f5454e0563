"""K1: the whole LQ solve (backward Riccati + forward rollout) in one CUDA
kernel launch.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ops/riccati.py`. The kernel
(`csrc/riccati.cu`, one thread block per problem instance) replaces the
Pallas TPU kernel `_riccati_kernel`; its plain version is the ported
`solver/riccati.py::backward_pass` (Cholesky) + `forward_pass`.

`riccati_rollout_cuda` / `riccati_rollout_plain` take the stage data with an
optional leading batch of instances and return (K, k, dxs, dus). Dispatch,
`riccati_rollout(lq, dx0, reg, backend)` -> (dxs, dus):
  "auto"  — the kernel for CUDA tensors, the plain version for CPU tensors;
  "cuda"  — the kernel (raises for tensors that are not on a CUDA device);
  "plain" — the plain version on any device (to hold the kernel against it).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib
from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass, forward_pass

_lib.register_counter(__name__)   # LAUNCHES and RECORDED (`ops/_lib.py`)

_FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")


def reset_launches() -> None:
    _lib.reset_launches(__name__)


def riccati_rollout_plain(A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0, reg: float = 1e-8):
    """Plain PyTorch version: (K [..,N,nu,nx], k [..,N,nu], dxs [..,N+1,nx], dus [..,N,nu])."""
    lq = types.SimpleNamespace(A=A, B=B, d=d, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu,
                               QN=QN, qN=qN)
    sol = backward_pass(lq, reg)
    dxs, dus = forward_pass(lq, sol, dx0)
    return sol.K, sol.k, dxs, dus


def riccati_rollout_cuda(A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0, reg: float = 1e-8):
    """Launch the kernel on the current stream; same contract as the plain version."""
    args = dict(zip(_FIELDS, (A, B, d, Qxx, Quu, Qux, qx, qu, QN, qN, dx0)))
    dev, dtype = A.device, A.dtype
    if not A.is_cuda or any(a.device != dev for a in args.values()):
        raise ValueError("riccati_rollout_cuda needs every input on one CUDA device")
    if dtype not in (torch.float32, torch.float64) or any(a.dtype != dtype for a in args.values()):
        raise ValueError("riccati_rollout_cuda takes float32 or float64 inputs of one dtype")
    N, nx, nu = A.shape[-3], A.shape[-1], B.shape[-1]
    lead = A.shape[:-3]
    want = {"A": (N, nx, nx), "B": (N, nx, nu), "d": (N, nx), "Qxx": (N, nx, nx),
            "Quu": (N, nu, nu), "Qux": (N, nu, nx), "qx": (N, nx), "qu": (N, nu),
            "QN": (nx, nx), "qN": (nx,), "dx0": (nx,)}
    for name, a in args.items():
        if tuple(a.shape) != tuple(lead) + want[name]:
            raise ValueError(f"riccati_rollout_cuda: {name} has shape {tuple(a.shape)}, "
                             f"expected {tuple(lead) + want[name]}")
    lib = _lib.library()
    smem = lib.wbmpc_riccati_smem_bytes(nx, nu, A.element_size())
    if smem > 232448:
        raise ValueError(f"riccati_rollout_cuda: (nx, nu) = ({nx}, {nu}) in {dtype} needs "
                         f"{smem} bytes of shared memory, more than a block's 227 KB")
    batch = 1
    for s in lead:
        batch *= int(s)
    ins = [a.contiguous() for a in args.values()]
    K = torch.empty(*lead, N, nu, nx, dtype=dtype, device=dev)
    k = torch.empty(*lead, N, nu, dtype=dtype, device=dev)
    dxs = torch.empty(*lead, N + 1, nx, dtype=dtype, device=dev)
    dus = torch.empty(*lead, N, nu, dtype=dtype, device=dev)
    fn = (lib.wbmpc_riccati_rollout_f32 if dtype == torch.float32
          else lib.wbmpc_riccati_rollout_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(a.data_ptr() for a in ins), K.data_ptr(), k.data_ptr(), dxs.data_ptr(),
              dus.data_ptr(), batch, N, nx, nu, float(reg), stream)
    _lib.check(lib, code, "riccati kernel")
    _lib.count_launch(__name__)
    return K, k, dxs, dus


def random_lq_data(rng, N=28, nx=58, nu=11, dtype=np.float32, quu_span=1.0) -> dict:
    """Random well-posed LQ stage data (SPD Quu/Qxx, near-identity A) as numpy
    arrays keyed like `riccati_rollout_*`'s arguments: the generator of
    `tests/test_ops_riccati.py::_lq_data`, for the tests and the kernel harness
    (`chip_smoke.py`).
    quu_span > 1 spreads the Quu diagonal across magnitudes to exercise the
    relative regularization."""
    A = np.tile(np.eye(nx, dtype=dtype)[None], (N, 1, 1)) \
        + rng.normal(size=(N, nx, nx)).astype(dtype) * 0.01
    B = rng.normal(size=(N, nx, nu)).astype(dtype) * 0.05
    d = rng.normal(size=(N, nx)).astype(dtype) * 0.01
    Wx = rng.normal(size=(N, nx, nx)).astype(dtype) * 0.1
    Qxx = Wx @ np.swapaxes(Wx, -1, -2) + 0.5 * np.eye(nx, dtype=dtype)
    Wu = rng.normal(size=(N, nu, nu)).astype(dtype) * 0.1
    su = (quu_span ** rng.uniform(-1, 1, size=(N, 1, 1))).astype(dtype)
    Quu = (Wu @ np.swapaxes(Wu, -1, -2) + 0.5 * np.eye(nu, dtype=dtype)) * su
    Qux = rng.normal(size=(N, nu, nx)).astype(dtype) * 0.05
    qx = rng.normal(size=(N, nx)).astype(dtype) * 0.1
    qu = rng.normal(size=(N, nu)).astype(dtype) * 0.1
    QN = Wx[0].T @ Wx[0] + np.eye(nx, dtype=dtype)
    qN = rng.normal(size=(nx,)).astype(dtype) * 0.1
    dx0 = rng.normal(size=(nx,)).astype(dtype) * 0.1
    return dict(A=A, B=B, d=d, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, QN=QN, qN=qN, dx0=dx0)


def riccati_rollout(lq, dx0, reg: float = 1e-8, backend: str = "auto"):
    """Drop-in for `backward_pass(lq, reg)` + `forward_pass`: (dxs, dus)."""
    if backend == "auto":
        backend = "cuda" if lq.A.is_cuda else "plain"
    if backend == "plain":
        fn = riccati_rollout_plain
    elif backend == "cuda":
        fn = riccati_rollout_cuda
    else:
        raise ValueError(f"unknown riccati backend {backend!r}")
    _, _, dxs, dus = fn(lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu,
                        lq.QN, lq.qN, dx0, reg=reg)
    return dxs, dus
