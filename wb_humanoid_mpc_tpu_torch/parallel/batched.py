"""Batched MPC solves: many problem instances as one solve.

PyTorch counterpart of `make_batched_solver` in
`wb_humanoid_mpc_tpu/parallel/batched.py` (the scaling layer: gait, command
and state variations of one MPC problem solved together). JAX gets the batch
from `vmap(solve)`; the port's kernels are `ctypes` calls, which
`torch.func.vmap` cannot trace, so the batch is an explicit leading axis
through the solver (`solver/sqp.py`): one linearization over instances x
nodes, one K1 launch with a block per instance, one K2 launch per flow stage
over instances x nodes, and the filter ladder's lower steps tried once for
the instances that accepted neither top step.

`shard_batched_solver` lays the batch across the `dp` axis of a rank mesh
(`parallel/multihost.py`): each dp-rank solves its rows with
`make_batched_solver`, and one `all_gather` over `dp` gives every rank the
whole solution. The solve is embarrassingly parallel over instances, so
nothing else is communicated.
"""

from __future__ import annotations

from typing import Callable

import torch

from wb_humanoid_mpc_tpu_torch.parallel.collectives import all_gather, pack, unpack
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolution, SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory


def make_batched_solver(ocp, flow, bp, cfg: SqpSolverConfig, *, device="cuda") -> Callable:
    """solve_batched(t0, x0 [B, nx], init_traj [B, ...], params [B, N+1, ...],
    lam [B, N, n_eq]) -> SqpSolution with a leading B on every field but
    `iterations`. t0 is shared by the instances, as JAX's `in_axes=None`.
    On the card the solve runs as CUDA graphs, one graph set per B
    (`make_sqp_solver`'s default)."""
    solve = make_sqp_solver(ocp, flow, bp, cfg, device=device)
    N = cfg.n_nodes

    def solve_batched(t0, x0, init_traj: Trajectory, params, lam):
        if x0.dim() != 2:
            raise ValueError(f"solve_batched takes x0 [B, nx], got shape {tuple(x0.shape)}")
        B = x0.shape[0]
        want = {"init_traj.xs": (init_traj.xs, (B, N + 1)), "init_traj.us": (init_traj.us, (B, N)),
                "lam": (lam, (B, N))}
        want.update({f"params.{f}": (a, (B, N + 1)) for f, a in zip(params._fields, params)})
        for name, (a, lead) in want.items():
            if tuple(a.shape[:2]) != lead:
                raise ValueError(f"solve_batched: {name} has shape {tuple(a.shape)}, expected "
                                 f"leading dims {lead}")
        return solve(t0, x0, init_traj, params, lam)

    return solve_batched


def _map(fn, tree):
    """fn over the tensors of nested tuples / NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = [_map(fn, t) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def shard_batched_solver(ocp, flow, bp, cfg: SqpSolverConfig, mesh, axis: str = "dp", *,
                         device="cuda") -> tuple[Callable, Callable]:
    """Data-parallel batched solve over `mesh` along `axis`.

    Returns (solve_fn, shard_fn): shard_fn(tree) takes this rank's rows of a
    tree of tensors with a leading batch B (B a multiple of the axis size);
    solve_fn(t0, x0 [B/n, nx], init_traj, params, lam), with the rows
    shard_fn gave, solves them and returns the SqpSolution of all B
    instances on every rank."""
    solve = make_batched_solver(ocp, flow, bp, cfg, device=device)
    group, n, i = mesh.group(axis), mesh.shape[axis], mesh.index(axis)

    def shard_fn(tree):
        def rows(a):
            if a.shape[0] % n:
                raise ValueError(f"shard_fn: batch {a.shape[0]} is not a multiple of {n}")
            b = a.shape[0] // n
            return a[i * b:(i + 1) * b]

        return _map(rows, tree)

    def solve_fn(t0, x0, init_traj: Trajectory, params, lam) -> SqpSolution:
        sol = solve(t0, x0, init_traj, params, lam)
        fields = [sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.defect_norm,
                  sol.step_size]
        flat, tails = pack(fields, 1)
        xs, us, lam_o, cost, g, dn, step = unpack(all_gather(flat, group), tails, 1)
        return SqpSolution(traj=Trajectory(xs=xs, us=us), lam=lam_o, cost=cost, g_norm=g,
                           defect_norm=dn, step_size=step, iterations=sol.iterations)

    return solve_fn, shard_fn
