"""The collectives of the sharded solvers, over `torch.distributed` groups.

PyTorch counterparts of the `jax.lax` collectives that the JAX package calls
inside `shard_map` (`parallel/horizon.py`, `solver/sharded_sqp.py`). A mesh
axis of JAX is a process group here (`parallel/multihost.py::MpcMesh`); each
function is called by every rank of the group, in the same order.

- `all_gather`: `jax.lax.all_gather(x, axis, axis=0, tiled=True)`:
  `all_gather_into_tensor` on `nccl`, and on `gloo` the list form of
  `dist.all_gather` into views of one tensor;
- `next_block`: the shift-by-one `ppermute` with perm [(j, j - 1 mod n)],
  i.e. rank i receives rank i + 1's tensor (the last rank rank 0's). `gloo`
  has no send/recv for CUDA tensors, so it is an `all_gather` of which each
  rank keeps one entry;
- `psum`, `pmax`: `jax.lax.psum` / `jax.lax.pmax`, an `all_reduce`;
- `axis_index`, `axis_size`: `jax.lax.axis_index` / `jax.lax.axis_size`.

Each collective takes an optional `out`, a tensor of the caller's that
receives the result (`gathered_like` makes one for a gather; a reduction
may reduce its input in place): a CUDA graph that reads the result after
the collective reads a tensor whose address its capture saw
(`solver/graphs.py::ShardedGraphSet`). Without `out` each allocates its
result.

`counts()` gives the collectives run by kind, so that a caller can report
the collectives of a solve; `reset_counts` sets them to 0. They count
through `ops/_lib.py`'s launch registry: a collective recorded into a CUDA
graph counts at each replay of that graph.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist

from wb_humanoid_mpc_tpu_torch.ops import _lib

KINDS = ("all_gather", "all_reduce")
for _kind in KINDS:
    _lib.register_counter(f"{__name__}.{_kind}", types.SimpleNamespace())


def counts() -> dict[str, int]:
    """{kind: collectives run since the last reset}."""
    return {k: _lib.COUNTERS[f"{__name__}.{k}"].LAUNCHES for k in KINDS}


def reset_counts() -> None:
    for k in KINDS:
        _lib.reset_launches(f"{__name__}.{k}")


def axis_index(group) -> int:
    """This rank's index along the group."""
    return dist.get_group_rank(group, dist.get_rank())


def axis_size(group) -> int:
    return dist.get_world_size(group)


def gathered_like(t: torch.Tensor, group) -> torch.Tensor:
    """An empty [size * n, ...] tensor for `all_gather(t, group, out)`."""
    return t.new_empty((axis_size(group) * t.shape[0], *t.shape[1:]))


def all_gather(t: torch.Tensor, group, out: torch.Tensor | None = None) -> torch.Tensor:
    """[n, ...] -> [size * n, ...]: every rank's tensor, in rank order along
    the group, concatenated on dim 0 (into `out` when given)."""
    t = t.contiguous()
    if out is None:
        out = gathered_like(t, group)
    _lib.count_launch(f"{__name__}.all_gather", t.is_cuda)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        dist.all_gather(list(out.chunk(axis_size(group))), t, group=group)
    return out


def next_block(t: torch.Tensor, group, out: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor of the next rank along the group (rank 0's on the last):
    a view of the gather of every rank's (into `out`, [size, *t.shape], when
    given)."""
    parts = all_gather(t[None], group, out)
    return parts[(axis_index(group) + 1) % axis_size(group)]


def _all_reduce(t: torch.Tensor, op, group, out) -> torch.Tensor:
    if out is None:
        out = t.clone(memory_format=torch.contiguous_format)
    elif out is not t:
        out.copy_(t)
    _lib.count_launch(f"{__name__}.all_reduce", out.is_cuda)
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(t: torch.Tensor, group, out: torch.Tensor | None = None) -> torch.Tensor:
    """The sum over the group (into `out`, which may be `t` itself)."""
    return _all_reduce(t, dist.ReduceOp.SUM, group, out)


def pmax(t: torch.Tensor, group, out: torch.Tensor | None = None) -> torch.Tensor:
    """The maximum over the group (into `out`, which may be `t` itself)."""
    return _all_reduce(t, dist.ReduceOp.MAX, group, out)


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
