"""Gauss-Newton DDP (iLQR) solver: the reference's alternative solver.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/ddp.py` (ocs2's
`GaussNewtonDDP`, chosen by the launch argument `solver: "sqp" | "ddp"`). It
shares the LQ machinery with the SQP path ("exact" sensitivity, as JAX's
default); the difference is the forward pass: instead of a linear update of
both trajectories (multiple shooting), DDP rolls the nonlinear dynamics
closed-loop under the Riccati feedback policy

    u_k = u_bar_k + alpha k_k + K_k (x_k - x_bar_k),   x_{k+1} = F(x_k, u_k),

so the defects are zero by construction (single shooting). Every step size
rolls at once, as a leading batch over the steps in a Python loop over the
nodes (JAX: `vmap` over a `lax.scan`). Like JAX's, which runs in XLA on the
TPU too, this uses the plain sequential `backward_pass` and the per-sample
`flow`: no kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolution, SqpSolverConfig
from wb_humanoid_mpc_tpu_torch.solver.transcription import (
    Trajectory,
    make_lq_functions,
    rk4_step,
)
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


def make_ddp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                    device="cuda") -> Callable:
    """Returns solve(t0, x0, init_traj, params, lam) -> SqpSolution.

    Every tensor passed to `solve` lies on `device` (the CUDA card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    fns = make_lq_functions(ocp, flow, cfg.dt, cfg.n_nodes, bp)

    def rollout(x0, traj, sol, alphas, times):
        """Closed-loop nonlinear rollouts, one per step in alphas [B]:
        Trajectory with xs [B, N+1, nx], us [B, N, nu]."""
        x = x0.expand(alphas.shape[0], -1)
        xs, us = [x], []
        for i in range(cfg.n_nodes):
            u = (traj.us[i] + alphas[:, None] * sol.k[i]
                 + ((x - traj.xs[i]) @ sol.K[i].transpose(-1, -2)))
            x = rk4_step(flow, times[i], x, u, cfg.dt)
            xs.append(x)
            us.append(u)
        return Trajectory(xs=torch.stack(xs, dim=-2), us=torch.stack(us, dim=-2))

    def ddp_iteration(traj, lam, times, params, x0, alphas):
        lq = fns.lq_approximation(traj, times, params, lam, cfg.rho)
        sol = backward_pass(lq, cfg.reg)
        cost0, _ = fns.total_cost(traj, times, params, lam, cfg.rho)
        # the steps and, last, the zero step (the re-anchored fallback)
        cands = rollout(x0, traj, sol, torch.cat([alphas, alphas.new_zeros(1)]), times)
        n = alphas.shape[0]
        costs, _ = fns.total_cost(Trajectory(xs=cands.xs[:n], us=cands.us[:n]), times,
                                  params, lam, cfg.rho)
        costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, float("inf")))
        # the best candidate (all rollouts already evaluated)
        pick = torch.argmin(costs)
        accept = costs[pick] < cost0
        alpha = torch.where(accept, alphas[pick], torch.zeros_like(alphas[pick]))
        # if not accepted, keep the previous trajectory re-anchored at x0
        new_traj = Trajectory(xs=torch.where(accept, cands.xs[pick], cands.xs[n]),
                              us=torch.where(accept, cands.us[pick], cands.us[n]))
        g = fns.eq_residuals(new_traj, times, params)
        new_lam = lam + cfg.rho * g
        stats = (lq.cost, torch.amax(torch.abs(g)), torch.zeros_like(lq.cost), alpha)
        return new_traj, new_lam, stats

    def solve(t0, x0, init_traj: Trajectory, params, lam) -> SqpSolution:
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = t0 + cfg.dt * torch.arange(cfg.n_nodes + 1, dtype=x0.dtype, device=dev)
        alphas = torch.tensor(cfg.alphas, dtype=x0.dtype, device=dev)
        traj, stats = init_traj, None
        for _ in range(cfg.sqp_iterations):
            traj, lam, stats = ddp_iteration(traj, lam, times, params, x0, alphas)
        cost, g_norm, defect_norm, alpha = stats
        return SqpSolution(traj=traj, lam=lam, cost=cost, g_norm=g_norm,
                           defect_norm=defect_norm, step_size=alpha,
                           iterations=cfg.sqp_iterations)

    return solve
