"""SQP solver: projection + filter line-search path.

PyTorch counterpart of `make_sqp_solver` in `wb_humanoid_mpc_tpu/solver/sqp.py`.
Per iteration:
  1. batched LQ approximation (one linearization of every node at once)
  2. equality projection onto the constraint null space, relative Levenberg
     damping, and the fused Riccati + rollout (the CUDA kernel `ops/riccati.py`
     on the card, one launch)
  3. control recovery du = L dx + Z dz + w
  4. filter line search: the two largest steps are evaluated together, and
     the rest of the ladder only when both fail.

JAX fuses an iteration into one XLA program; the port runs eagerly (no
`torch.compile`, no CUDA graphs yet). The options the JAX config has and the
port does not (the AL equality path, the merit line search, the
associative-scan Riccati, the "exact" and "midpoint" sensitivities) raise
`NotImplementedError` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.ops.riccati import riccati_rollout
from wb_humanoid_mpc_tpu_torch.solver.linesearch import filter_accept
from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq, recover_controls
from wb_humanoid_mpc_tpu_torch.solver.riccati import levenberg_damp
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory, make_lq_functions
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


class SqpSolution(NamedTuple):
    traj: Trajectory
    lam: torch.Tensor        # [N, n_eq] multipliers (unchanged on the projection path)
    cost: torch.Tensor
    g_norm: torch.Tensor     # max |equality residual|
    defect_norm: torch.Tensor
    step_size: torch.Tensor  # last accepted alpha
    iterations: int


@dataclasses.dataclass(frozen=True)
class SqpSolverConfig:
    """The fields of the JAX `SqpSolverConfig` that the projection + filter
    path reads (see that class for each one), and the four that select a
    path the port does not have yet (any other value raises). The AL and
    merit fields come with those paths."""
    n_nodes: int
    dt: float
    sqp_iterations: int = 1
    rho: float = 1e3
    reg: float = 1e-2
    reg_num: float = 1e-8
    alphas: tuple = (1.0, 0.7, 0.5, 0.3, 0.2, 0.1, 0.05, 0.01)
    parallel_riccati: bool = False
    equality_handling: str = "projection"
    proj_eps: float = 1e-8
    sensitivity: str = "node"
    line_search: str = "filter"
    filter_g_max: float = 1e-2
    filter_g_min: float = 1e-6
    # "auto": the CUDA Riccati kernel for CUDA tensors, the plain version for
    # CPU tensors; "cuda" | "plain" force one (ops/riccati.py)
    rollout_backend: str = "auto"
    # the same for the FK + velocity tree pass of the RK4 tail (ops/fkvel.py)
    flow_backend: str = "auto"


def _check_ported(cfg: SqpSolverConfig) -> None:
    unported = {
        "equality_handling": (cfg.equality_handling, "projection"),
        "line_search": (cfg.line_search, "filter"),
        "sensitivity": (cfg.sensitivity, "node"),
        "parallel_riccati": (cfg.parallel_riccati, False),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(f"SqpSolverConfig.{name}={value!r} is not ported yet "
                                      f"(only {ported!r})")


def make_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                    device="cuda") -> Callable:
    """Returns solve(t0, x0, init_traj, params, lam) -> SqpSolution.

    Every tensor passed to `solve` lies on `device` (the CUDA card unless the
    caller asks for the CPU)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    model = getattr(ocp, "model", None)
    fmb = getattr(model, "flow_map_batch", None)
    flow_batch = (None if fmb is None
                  else (lambda ts, xs, us: fmb(ts, xs, us, backend=cfg.flow_backend)))
    lq_approx, eq_fn, candidate_perf, _ = make_lq_functions(
        ocp, flow, cfg.dt, cfg.n_nodes, bp, flow_batch=flow_batch)
    # unit equality weight in the LQ on the projection path (see the JAX solver)
    rho_lq = min(cfg.rho, 1.0)
    n_hi = 2

    def sqp_iteration(traj, times, params, lam, x0, alphas):
        # the ranges name the phases in a torch.profiler trace
        # (wb_humanoid_mpc_tpu_torch/tools/profile_sqp.py)
        with record_function("sqp.lq"):
            lq = lq_approx(traj, times, params, lam, rho_lq)
        dx0 = x0 - traj.xs[0]
        with record_function("sqp.projection"):
            reduced, proj = project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)
            reduced = levenberg_damp(reduced, cfg.reg)
        with record_function("sqp.riccati"):
            dxs, dzs = riccati_rollout(reduced, dx0, cfg.reg_num, cfg.rollout_backend)
            dus = recover_controls(proj, dxs, dzs)

        # ocs2 FilterLinesearch: the largest accepted step wins. The baseline
        # (c0, v0) comes with the LQ pass; the top-2 steps are tried first.
        c0, v0 = lq.cost_pure, lq.viol

        def try_alphas(a):
            cand = Trajectory(xs=traj.xs + a[:, None, None] * dxs,
                              us=traj.us + a[:, None, None] * dus)
            cs, vs = candidate_perf(cand, times, params)
            return filter_accept(c0, v0, cs, vs, cfg.filter_g_max, cfg.filter_g_min)

        with record_function("sqp.linesearch"):
            ok_hi = try_alphas(alphas[:n_hi])
            # JAX takes this branch with lax.cond on the device; here it is
            # one host sync per iteration
            if bool(ok_hi.any()):
                ok_lo = torch.zeros(alphas.shape[0] - n_hi, dtype=torch.bool,
                                    device=alphas.device)
            else:
                ok_lo = try_alphas(alphas[n_hi:])
            ok = torch.cat([ok_hi, ok_lo])
            alpha = alphas[torch.argmax(ok.to(alphas.dtype))] * ok.any().to(alphas.dtype)
            new_traj = Trajectory(xs=traj.xs + alpha * dxs, us=traj.us + alpha * dus)
        with record_function("sqp.eq_residuals"):
            g_max = torch.amax(torch.abs(eq_fn(new_traj, times, params)))
        return new_traj, (lq.cost, g_max, lq.defect_norm, alpha)

    def solve(t0, x0, init_traj: Trajectory, params, lam) -> SqpSolution:
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = t0 + cfg.dt * torch.arange(cfg.n_nodes + 1, dtype=x0.dtype, device=dev)
        alphas = torch.tensor(cfg.alphas, dtype=x0.dtype, device=dev)
        traj, stats = init_traj, None
        for _ in range(cfg.sqp_iterations):
            traj, stats = sqp_iteration(traj, times, params, lam, x0, alphas)
        cost, g_norm, defect_norm, alpha = stats
        return SqpSolution(traj=traj, lam=lam, cost=cost, g_norm=g_norm,
                           defect_norm=defect_norm, step_size=alpha,
                           iterations=cfg.sqp_iterations)

    return solve
