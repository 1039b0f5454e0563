"""K2: the FK + velocity/bias tree pass as one CUDA kernel launch.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ops/fkvel.py`. The kernel
(`csrc/fkvel.cu`, one thread per batch element) replaces the Pallas TPU
kernel `_fkvel_kernel`; its plain version is the level-parallel
`models/kinematics.py::forward_kinematics_vel` run on a batch.

Dispatch, `fkvel_batch(model, q, v, backend)`:
  "auto"  — the kernel for CUDA tensors, the plain version for CPU tensors;
  "cuda"  — the kernel (raises for tensors that are not on a CUDA device);
  "plain" — the plain version on any device (to hold the kernel against it).
"""

from __future__ import annotations

import torch

from wb_humanoid_mpc_tpu_torch.models.kinematics import (
    FK,
    VelBias,
    _tree_levels,
    forward_kinematics_vel,
)
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel
from wb_humanoid_mpc_tpu_torch.ops import _lib

# kernel launches since the last reset (a plain count, read by chip_smoke.py)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def fkvel_plain(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> tuple[FK, VelBias]:
    """The plain PyTorch version: q, v [B, nq] -> (FK, VelBias) with a leading B."""
    return forward_kinematics_vel(model, q, v)


def _tables(model: RobotModel, device: torch.device, dtype: torch.dtype):
    """The joint tables the kernel reads, built once per (model, device, dtype)."""
    key = ("fkvel", device, dtype)
    hit = model.tensor_cache.get(key)
    if hit is None:
        parents = tuple(int(p) for p in model.joint_parent_body)
        order = [int(j) for idx in _tree_levels(parents) for j in idx]

        def t(a, dt):
            return torch.as_tensor(a, dtype=dt, device=device).contiguous()

        hit = (t(order, torch.int32), t(parents, torch.int32), t(model.joint_R, dtype),
               t(model.joint_p, dtype), t(model.joint_axis, dtype))
        model.tensor_cache[key] = hit
    return hit


def fkvel_cuda(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> tuple[FK, VelBias]:
    """Launch the kernel on the current stream: q, v [B, nq] CUDA tensors."""
    if not (q.is_cuda and v.is_cuda and q.device == v.device):
        raise ValueError("fkvel_cuda needs q and v on one CUDA device")
    if q.dtype not in (torch.float32, torch.float64) or v.dtype != q.dtype:
        raise ValueError(f"fkvel_cuda takes float32 or float64, got {q.dtype}/{v.dtype}")
    n_j, n_b = model.n_joints, model.n_bodies
    if q.dim() != 2 or q.shape[1] != model.nq or v.shape != q.shape:
        raise ValueError(f"fkvel_cuda needs q, v of shape [B, {model.nq}], got "
                         f"{tuple(q.shape)}, {tuple(v.shape)}")
    q, v = q.contiguous(), v.contiguous()
    B = q.shape[0]
    order, parent, jR, jp, axis = _tables(model, q.device, q.dtype)
    R = torch.empty(B, n_b, 3, 3, dtype=q.dtype, device=q.device)
    p = torch.empty(B, n_b, 3, dtype=q.dtype, device=q.device)
    vb = torch.empty(B, n_b, 4, 3, dtype=q.dtype, device=q.device)
    axes = torch.empty(B, n_j, 3, dtype=q.dtype, device=q.device)
    E = torch.empty(B, 3, 3, dtype=q.dtype, device=q.device)
    lib = _lib.library()
    fn = lib.wbmpc_fkvel_f32 if q.dtype == torch.float32 else lib.wbmpc_fkvel_f64
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), v.data_ptr(), order.data_ptr(), parent.data_ptr(), jR.data_ptr(),
              jp.data_ptr(), axis.data_ptr(), float(model.gravity), R.data_ptr(), p.data_ptr(),
              vb.data_ptr(), axes.data_ptr(), E.data_ptr(), B, n_j, stream)
    _lib.check(lib, code, "fkvel kernel")
    global LAUNCHES
    LAUNCHES += 1
    fk = FK(R=R, p=p, joint_axis_w=axes, joint_origin_w=p[:, 1:], E_base=E)
    vel = VelBias(v_o=vb[:, :, 0], omega=vb[:, :, 1], a_o=vb[:, :, 2], domega=vb[:, :, 3])
    return fk, vel


def fkvel_batch(model: RobotModel, q: torch.Tensor, v: torch.Tensor,
                backend: str = "auto") -> tuple[FK, VelBias]:
    """Batched FK + velocity/bias pass: q, v [B, nq] -> (FK, VelBias) whose
    fields carry a leading batch dim."""
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "plain"
    if backend == "plain":
        return fkvel_plain(model, q, v)
    if backend == "cuda":
        return fkvel_cuda(model, q, v)
    raise ValueError(f"unknown fkvel backend {backend!r}")
