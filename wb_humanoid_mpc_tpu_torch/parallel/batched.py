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

`shard_batched_solver` (the batch laid across a device mesh) is not ported.
"""

from __future__ import annotations

from typing import Callable

from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory


def make_batched_solver(ocp, flow, bp, cfg: SqpSolverConfig, *, device="cuda") -> Callable:
    """solve_batched(t0, x0 [B, nx], init_traj [B, ...], params [B, N+1, ...],
    lam [B, N, n_eq]) -> SqpSolution with a leading B on every field but
    `iterations`. t0 is shared by the instances, as JAX's `in_axes=None`."""
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
