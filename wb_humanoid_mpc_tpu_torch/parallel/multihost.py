"""The rank mesh: processes joined by `torch.distributed`, laid out as
("dp", "h").

PyTorch counterpart of `wb_humanoid_mpc_tpu/parallel/multihost.py`. One
process is one rank, the counterpart of one device of JAX's `Mesh`. The
layout rule is JAX's: the collective-free axis `dp` (batched instances) may
cross hosts; the axis `h` (horizon blocks), which carries an `all_gather`
on every pass, stays within one host. Global ranks are host-major (torchrun
numbers the ranks of a host consecutively), so the row-major [n_dp, n_h]
grid keeps each h-row inside one host whenever n_h divides the ranks per
host.

- `initialize_multihost` joins this process to a process group.
- `mesh_layout` is the layout arithmetic, a pure function.
- `make_mpc_mesh` builds an `MpcMesh`: the grid, this rank's coordinates,
  one group per h-row and one per dp-column, the backend and the device.
- `mesh_report` summarises the mesh.
- `run_ranks` starts `world` ranks on this machine and returns what each
  returned: the counterpart of JAX's virtual CPU devices in the tests, and
  how `chip_smoke.py` puts several ranks on one card.

The backend is always the caller's choice: `nccl` for ranks with a card
each, `gloo` for ranks on the CPU or for several ranks on one card (NCCL
refuses two ranks on one GPU; `gloo` stages CUDA tensors through the host).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, *, backend: str,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to a process group of `backend`.

    With no arguments, torchrun's environment (`WORLD_SIZE`, `RANK`,
    `MASTER_ADDR`, `MASTER_PORT`) says where; otherwise pass all three. Does
    nothing when a group already exists or when the run has a single
    process, as JAX's `initialize_multihost`."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return   # a single-process run: nothing to join
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def mesh_layout(n_ranks: int, n_dp: int | None, n_h: int | None,
                ranks_per_host: int) -> tuple[int, int]:
    """(n_dp, n_h) of a mesh over `n_ranks` host-major ranks. Defaults:
    `n_h` = ranks per host (the horizon collectives stay within a host),
    `n_dp` = the rest. Raises when n_dp x n_h != n_ranks, or when an h-row
    would span hosts while n_dp > 1."""
    if n_h is None:
        n_h = ranks_per_host if n_ranks % ranks_per_host == 0 else n_ranks
    if n_dp is None:
        n_dp = n_ranks // n_h
    if n_dp * n_h != n_ranks:
        raise ValueError(f"mesh {n_dp}x{n_h} != {n_ranks} ranks")
    if n_h > ranks_per_host and n_dp > 1:
        raise ValueError(
            f"horizon axis ({n_h}) spans more than one host ({ranks_per_host} ranks/host): "
            "Riccati collectives would cross hosts — shrink n_h or grow n_dp")
    return n_dp, n_h


@dataclasses.dataclass(frozen=True)
class MpcMesh:
    """A ("dp", "h") grid of global ranks and this rank's groups.

    `grid[i, j]` is the global rank at dp index i, h index j. `coords` is
    this rank's (i, j), None for a rank outside the grid; `groups` maps each
    axis to this rank's group along it (its h-row for "h", its dp-column for
    "dp")."""
    grid: np.ndarray
    coords: tuple[int, int] | None
    groups: dict
    backend: str
    device: torch.device
    ranks_per_host: int

    axis_names = ("dp", "h")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def group(self, axis: str):
        return self.groups[axis]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]


def make_mpc_mesh(n_dp: int | None = None, n_h: int | None = None, ranks=None,
                  ranks_per_host: int | None = None, *, backend: str, device="cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> MpcMesh:
    """The ("dp", "h") mesh over `ranks` (all ranks of the process group by
    default). `ranks_per_host` overrides host detection (torchrun's
    `LOCAL_WORLD_SIZE`, else one host): the tests use it to lay out two
    hosts on one machine. Every rank of the process group calls this, in the
    same order as every other collective: each creates every row and column
    group, the ones it is not in too. On CUDA, each rank works on `device`
    (several ranks may share one card under `gloo`)."""
    dev = resolve_device(device)
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    n_dp, n_h = mesh_layout(len(ranks), n_dp, n_h, ranks_per_host)
    grid = np.array(ranks).reshape(n_dp, n_h)
    timeout = timedelta(seconds=timeout_s)
    me = dist.get_rank()
    groups = {}
    for axis, lines in (("h", list(grid)), ("dp", list(grid.T))):
        for line in lines:
            g = dist.new_group([int(r) for r in line], timeout=timeout, backend=backend)
            if me in line:
                groups[axis] = g
    where = np.argwhere(grid == me)
    coords = tuple(int(c) for c in where[0]) if len(where) else None
    return MpcMesh(grid=grid, coords=coords, groups=groups, backend=backend, device=dev,
                   ranks_per_host=ranks_per_host)


def mesh_report(mesh: MpcMesh) -> dict:
    """Topology summary: the keys of JAX's `mesh_report`, with
    `h_axis_within_host` for its `h_axis_on_ici` (each h-row on one host,
    so that the horizon collectives never leave it)."""
    host = mesh.grid // mesh.ranks_per_host
    h_hosts = [len(set(row.tolist())) for row in host]
    return {
        "axes": mesh.shape,
        "n_devices": mesh.size,
        "n_hosts": len(set(host.ravel().tolist())),
        "h_axis_hosts_per_row": h_hosts,
        "h_axis_within_host": all(k == 1 for k in h_hosts),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, timeout_s, results, fn, args):
    """One rank: join the group, run fn(*args), send (rank, ok, result)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s),
                                device_id=dev if backend == "nccl" else None)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:   # a rank's failure goes to the parent, which stops the rest
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, device="cuda", *args,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(*args) on `world` ranks of one machine and return each rank's
    result, in rank order.

    Each rank is a process started with `spawn` (`fn` and `args` are
    pickled: `fn` must be importable, and its result picklable, e.g. numpy),
    joined to a process group of `backend` over `tcp://localhost` whose
    collectives time out after `timeout_s`, with `device` as its current
    device. `spawn` re-imports the caller's main script in every rank (as
    `__mp_main__`), so that script must keep its work under
    `if __name__ == "__main__"` and must not import JAX at its top. Raises,
    and stops every rank, when a rank fails or all have not returned within
    `timeout_s`."""
    resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, device, timeout_s, results, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank process exited with code {dead[0].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks did not return "
                                       f"within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
    return [out[r] for r in range(world)]
