"""The collectives of the sharded solvers, over `torch.distributed` groups.

PyTorch counterparts of the `jax.lax` collectives that the JAX package calls
inside `shard_map` (`parallel/horizon.py`, `solver/sharded_sqp.py`). A mesh
axis of JAX is a process group here (`parallel/multihost.py::MpcMesh`); each
function is called by every rank of the group, in the same order.

- `all_gather`: `jax.lax.all_gather(x, axis, axis=0, tiled=True)`, in the
  list form of `dist.all_gather`, which the `gloo` and `nccl` backends both
  take for CPU and CUDA tensors;
- `next_block`: the shift-by-one `ppermute` with perm [(j, j - 1 mod n)],
  i.e. rank i receives rank i + 1's tensor (the last rank rank 0's). `gloo`
  has no send/recv for CUDA tensors, so it is an `all_gather` of which each
  rank keeps one entry;
- `psum`, `pmax`: `jax.lax.psum` / `jax.lax.pmax`, an `all_reduce`;
- `axis_index`, `axis_size`: `jax.lax.axis_index` / `jax.lax.axis_size`.

`COUNTS` counts the calls by kind, so that a caller can report the
collectives of a solve; `reset_counts` sets them to 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def axis_index(group) -> int:
    """This rank's index along the group."""
    return dist.get_group_rank(group, dist.get_rank())


def axis_size(group) -> int:
    return dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] -> [size * n, ...]: every rank's tensor, in rank order along
    the group, concatenated on dim 0."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(group))]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def next_block(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor of the next rank along the group (rank 0's on the last)."""
    n = axis_size(group)
    parts = all_gather(t[None], group)
    return parts[(axis_index(group) + 1) % n]


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    out = t.clone().contiguous()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def pack(tensors, lead: int) -> tuple[torch.Tensor, list]:
    """Flatten tensors that share their first `lead` dims into one tensor
    [*lead dims, total] (one collective instead of several); `unpack` undoes it."""
    shape = tensors[0].shape[:lead]
    flat = [t.reshape(*shape, -1) for t in tensors]
    return torch.cat(flat, dim=-1), [t.shape[lead:] for t in tensors]


def unpack(flat: torch.Tensor, tails: list, lead: int) -> list:
    shape = flat.shape[:lead]
    sizes = [int(torch.Size(s).numel()) for s in tails]
    return [p.reshape(*shape, *s) for p, s in zip(torch.split(flat, sizes, dim=-1), tails)]
