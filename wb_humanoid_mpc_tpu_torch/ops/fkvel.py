"""K2: the FK + velocity/bias tree pass as one CUDA kernel launch.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ops/fkvel.py`. The kernel
(`csrc/fkvel.cu`: one warp per batch element, the tree walked level by
level in shared memory, joint constants folded by the tables built here)
replaces the Pallas TPU kernel `_fkvel_kernel`; its plain version is the
level-parallel `models/kinematics.py::forward_kinematics_vel` run on a
batch.

Dispatch, `fkvel_batch(model, q, v, backend)`:
  "auto"  — the kernel for CUDA tensors, the plain version for CPU tensors;
  "cuda"  — the kernel (raises for tensors that are not on a CUDA device);
  "plain" — the plain version on any device (to hold the kernel against it).
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


# joint flags and axis codes of the kernel's table (csrc/fkvel.cu)
_IDENTITY_R, _NEGATIVE_AXIS, _GENERAL_AXIS = 1, 2, 3


def _tables(model: RobotModel, device: torch.device, dtype: torch.dtype):
    """(joints, geo, n_levels): the kernel's tables, built once per (model,
    device, dtype). In level order (`_tree_levels`), `joints` holds per joint
    its index, parent body, axis code (0, 1, 2 for +-x, +-y, +-z; 3 for a
    general axis) and flags (identity joint_R, negative axis), then the level
    offsets; `geo` holds per joint jR (9), jp (3), axis (3) and jR axis (3),
    taken in float64 and then cast."""
    key = ("fkvel", device, dtype)
    hit = model.tensor_cache.get(key)
    if hit is None:
        parents = tuple(int(p) for p in model.joint_parent_body)
        levels = _tree_levels(parents)
        jR = np.asarray(model.joint_R, dtype=np.float64)
        jp = np.asarray(model.joint_p, dtype=np.float64)
        axis = np.asarray(model.joint_axis, dtype=np.float64)
        ints, geo = [], []
        for j in (int(j) for idx in levels for j in idx):
            code, flags = _GENERAL_AXIS, 0
            for k in range(3):
                if abs(axis[j, k]) == 1.0 and not np.delete(axis[j], k).any():
                    code = k
                    flags |= _NEGATIVE_AXIS if axis[j, k] < 0 else 0
            if np.array_equal(jR[j], np.eye(3)):
                flags |= _IDENTITY_R
            ints += [j, parents[j], code, flags]
            geo.append(np.concatenate([jR[j].ravel(), jp[j], axis[j], jR[j] @ axis[j]]))
        ints += np.cumsum([0] + [len(idx) for idx in levels]).tolist()
        hit = (torch.as_tensor(ints, dtype=torch.int32, device=device),
               torch.as_tensor(np.stack(geo), dtype=dtype, device=device).contiguous(),
               len(levels))
        model.tensor_cache[key] = hit
    return hit


@functools.lru_cache(maxsize=64)
def _output_spec(B: int, n_b: int, n_j: int):
    """(values in the buffer, [(shape, strides, offset)] of R, p, vb, axes, E)."""
    shapes = ((B, n_b, 3, 3), (B, n_b, 3), (B, n_b, 4, 3), (B, n_j, 3), (B, 3, 3))
    spec, offset = [], 0
    for shape in shapes:
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        spec.append((shape, strides, offset))
        offset += math.prod(shape)
    return offset, tuple(spec)


def _outputs(B: int, n_b: int, n_j: int, like: torch.Tensor):
    """R, p, vb, axes, E as contiguous views of one new buffer."""
    total, spec = _output_spec(B, n_b, n_j)
    buf = torch.empty(total, dtype=like.dtype, device=like.device)
    return [buf.as_strided(shape, strides, offset) for shape, strides, offset in spec]


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
    joints, geo, n_levels = _tables(model, q.device, q.dtype)
    R, p, vb, axes, E = _outputs(B, n_b, n_j, q)
    lib = _lib.library()
    fn = lib.wbmpc_fkvel_f32 if q.dtype == torch.float32 else lib.wbmpc_fkvel_f64
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), v.data_ptr(), joints.data_ptr(), geo.data_ptr(), float(model.gravity),
              R.data_ptr(), p.data_ptr(), vb.data_ptr(), axes.data_ptr(), E.data_ptr(), B, n_j,
              n_levels, stream)
    _lib.check(lib, code, "fkvel kernel")
    global LAUNCHES
    LAUNCHES += 1
    fk = FK(R=R, p=p, joint_axis_w=axes, joint_origin_w=p[:, 1:], E_base=E)
    vel = VelBias(*vb.unbind(2))   # rows v_o, omega, a_o, domega
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
