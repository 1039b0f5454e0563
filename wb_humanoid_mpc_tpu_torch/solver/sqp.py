"""SQP solver.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/sqp.py`. Per iteration:
  1. batched LQ approximation (one linearization of every node at once)
  2. the LQ solve, by one of:
     - equality projection onto the constraint null space + relative
       Levenberg damping (the default), or the AL path (the full LQ at
       rho, damped);
     - then the fused Riccati + rollout (the CUDA kernel `ops/riccati.py`
       on the card, one launch) or the associative-scan pair
       (`solver/priccati.py`, `parallel_riccati`);
  3. control recovery du = L dx + Z dz + w (projection path)
  4. line search: the ocs2 filter (the two largest steps evaluated together,
     the rest of the ladder only when both fail) or the AL merit (all steps
     at once, the largest that decreases the merit)
  5. the safeguarded, clamped AL multiplier update (AL path only).

`make_staged_sqp_solver` runs the same iteration phase by phase and returns
each phase's wall time (the reference's benchmark contract).

`solve` also takes a leading batch of problem instances (JAX's
`vmap(solve)`, `parallel/batched.py`): x0 [B, nx], the trajectory, params
and multipliers with B before their node axis. The stage data of all
instances go through one linearization, one K1 launch over the batch and one
K2 launch per flow stage over instances x nodes; costs, norms and the
accepted step are per instance.

JAX fuses an iteration into one XLA program; the port runs eagerly (no
`torch.compile`, no CUDA graphs yet).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.ops.riccati import riccati_rollout
from wb_humanoid_mpc_tpu_torch.solver.linesearch import filter_accept
from wb_humanoid_mpc_tpu_torch.solver.priccati import (
    parallel_backward_pass,
    parallel_forward_pass,
)
from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq, recover_controls
from wb_humanoid_mpc_tpu_torch.solver.riccati import levenberg_damp
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory, make_lq_functions
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


class SqpSolution(NamedTuple):
    traj: Trajectory
    lam: torch.Tensor        # [N, n_eq] AL multipliers (unchanged on the projection path)
    cost: torch.Tensor
    g_norm: torch.Tensor     # max |equality residual|
    defect_norm: torch.Tensor
    step_size: torch.Tensor  # last accepted alpha
    iterations: int


@dataclasses.dataclass(frozen=True)
class SqpSolverConfig:
    """The JAX `SqpSolverConfig` (see that class for each field), with the
    port's two backend fields."""
    n_nodes: int
    dt: float
    sqp_iterations: int = 1
    rho: float = 1e3
    reg: float = 1e-2
    reg_num: float = 1e-8
    alphas: tuple = (1.0, 0.7, 0.5, 0.3, 0.2, 0.1, 0.05, 0.01)
    defect_weight: float = 1e2
    parallel_riccati: bool = False
    lam_max: float = 1e4
    al_decrease: float = 0.9
    al_update_threshold: float = 0.5
    equality_handling: str = "projection"   # "projection" | "al"
    proj_eps: float = 1e-8
    sensitivity: str = "node"                # "node" | "midpoint" | "exact"
    line_search: str = "filter"              # "filter" | "merit"
    filter_g_max: float = 1e-2
    filter_g_min: float = 1e-6
    # "auto": the CUDA Riccati kernel for CUDA tensors, the plain version for
    # CPU tensors; "cuda" | "plain" force one (ops/riccati.py)
    rollout_backend: str = "auto"
    # the same for the FK + velocity tree pass of the RK4 tail and the line
    # search (ops/fkvel.py)
    flow_backend: str = "auto"


class PhaseTimings(NamedTuple):
    """Per-solve wall times by phase [s], summed over the SQP iterations: the
    reference's `SqpSolver::Benchmarks` (lq <-> linearQuadraticApproximationTime,
    projection + riccati <-> solveQpTime, linesearch <-> linesearchTime)."""
    lq: float
    projection: float
    riccati: float
    linesearch: float


def _check_config(cfg: SqpSolverConfig) -> None:
    for name, allowed in (("equality_handling", ("projection", "al")),
                          ("line_search", ("filter", "merit")),
                          ("sensitivity", ("node", "midpoint", "exact"))):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"SqpSolverConfig.{name}={getattr(cfg, name)!r}: expected one of "
                             f"{allowed}")


def model_flow_batch(ocp, cfg: SqpSolverConfig):
    """The model's `flow_map_batch` with `cfg.flow_backend` (K2 for CUDA
    tensors), or None when the model has none."""
    fmb = getattr(getattr(ocp, "model", None), "flow_map_batch", None)
    return None if fmb is None else (lambda ts, xs, us: fmb(ts, xs, us, backend=cfg.flow_backend))


def _lq_functions(ocp, flow, bp, cfg):
    return make_lq_functions(ocp, flow, cfg.dt, cfg.n_nodes, bp, sensitivity=cfg.sensitivity,
                             flow_batch=model_flow_batch(ocp, cfg))


def _rho_lq(cfg: SqpSolverConfig) -> float:
    # With exact projection the equality penalty must not dominate the LQ
    # cost (see the JAX solver): a unit weight on the projection path; the
    # AL path keeps the full rho. The merit always uses cfg.rho.
    return cfg.rho if cfg.equality_handling == "al" else min(cfg.rho, 1.0)


_STAGE_FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu")


def _solve_lq(lq, dx0, cfg: SqpSolverConfig):
    """The damped LQ's (dxs, dus): the fused kernel path (a leading batch of
    instances in one launch) or the scan pair."""
    if cfg.parallel_riccati:
        # the scans run over axis 0: the node axis goes before the batch
        nb = dx0.dim() - 1
        lq = lq._replace(**{f: torch.movedim(getattr(lq, f), nb, 0) for f in _STAGE_FIELDS})
        dxs, dus = parallel_forward_pass(lq, parallel_backward_pass(lq, cfg.reg_num), dx0)
        return torch.movedim(dxs, 0, nb), torch.movedim(dus, 0, nb)
    return riccati_rollout(lq, dx0, cfg.reg_num, cfg.rollout_backend)


def _times(t0, x0, cfg):
    """[*batch, N+1] node times: one grid, broadcast over x0's batch dims."""
    times = t0 + cfg.dt * torch.arange(cfg.n_nodes + 1, dtype=x0.dtype, device=x0.device)
    return times.expand(*x0.shape[:-1], cfg.n_nodes + 1)


def _step(traj, alpha, dxs, dus) -> Trajectory:
    """traj + alpha (dxs, dus), alpha one step per instance ([*batch])."""
    a = alpha[..., None, None]
    return Trajectory(xs=traj.xs + a * dxs, us=traj.us + a * dus)


def _candidates(traj, alphas, dxs, dus) -> Trajectory:
    """Line-search candidates traj + alpha (dxs, dus) for each of alphas [C]:
    a leading candidate dim before the batch dims."""
    a = alphas.reshape(-1, *([1] * dxs.dim()))
    return Trajectory(xs=traj.xs + a * dxs, us=traj.us + a * dus)


def _first_true(alphas, ok):
    """Per instance, the first (largest) alpha whose candidate is accepted,
    or 0 when none is: ok [C, *batch] -> [*batch]."""
    return alphas[torch.argmax(ok.to(alphas.dtype), dim=0)] * ok.any(dim=0).to(alphas.dtype)


def make_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                    device="cuda") -> Callable:
    """Returns solve(t0, x0, init_traj, params, lam) -> SqpSolution.

    Every tensor passed to `solve` lies on `device` (the CUDA card unless the
    caller asks for the CPU)."""
    _check_config(cfg)
    dev = resolve_device(device)
    fns = _lq_functions(ocp, flow, bp, cfg)
    rho_lq = _rho_lq(cfg)
    n_hi = 2

    def merit(traj, times, params, lam):
        c, _ = fns.total_cost(traj, times, params, lam, cfg.rho)
        d = fns.defects(traj, times)
        return c + cfg.defect_weight * torch.sum(torch.abs(d), dim=(-2, -1))

    def sqp_iteration(traj, lam, g_prev, times, params, x0, alphas):
        # the ranges name the phases in a torch.profiler trace
        # (wb_humanoid_mpc_tpu_torch/tools/profile_sqp.py)
        with record_function("sqp.lq"):
            lq = fns.lq_approximation(traj, times, params, lam, rho_lq)
        dx0 = x0 - traj.xs[..., 0, :]
        if cfg.equality_handling == "projection":
            with record_function("sqp.projection"):
                reduced, proj = project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)
                reduced = levenberg_damp(reduced, cfg.reg)
            with record_function("sqp.riccati"):
                dxs, dzs = _solve_lq(reduced, dx0, cfg)
                dus = recover_controls(proj, dxs, dzs)
        else:
            with record_function("sqp.riccati"):
                # the unprojected LQ (nu = 35 on humanoid23) through K1
                dxs, dus = _solve_lq(levenberg_damp(lq, cfg.reg), dx0, cfg)

        with record_function("sqp.linesearch"):
            if cfg.line_search == "filter":
                # ocs2 FilterLinesearch: the largest accepted step wins. The
                # baseline (c0, v0) comes with the LQ pass; the top-2 steps
                # are tried first. Every instance of a batch has its own.
                c0, v0 = lq.cost_pure, lq.viol

                def try_alphas(a):
                    cs, vs = fns.candidate_perf(_candidates(traj, a, dxs, dus), times, params)
                    return filter_accept(c0, v0, cs, vs, cfg.filter_g_max, cfg.filter_g_min)

                ok_hi = try_alphas(alphas[:n_hi])
                # JAX takes this branch with lax.cond on the device (a select
                # under vmap); here it is one host sync per iteration: the
                # rest of the ladder runs when some instance accepted neither
                # top step, and counts only for those instances
                need_lo = ~ok_hi.any(dim=0)
                if bool(need_lo.any()):
                    ok_lo = try_alphas(alphas[n_hi:]) & need_lo
                else:
                    ok_lo = torch.zeros(alphas.shape[0] - n_hi, *need_lo.shape,
                                        dtype=torch.bool, device=alphas.device)
                alpha = _first_true(alphas, torch.cat([ok_hi, ok_lo]))
            else:
                # AL merit: all steps at once (one K2 launch per flow stage
                # over steps x instances x nodes); the largest step that
                # decreases it
                merit0 = merit(traj, times, params, lam)
                merits = merit(_candidates(traj, alphas, dxs, dus), times, params, lam)
                # a candidate that produced NaN/inf must never be selected
                merits = torch.where(torch.isfinite(merits), merits,
                                     torch.full_like(merits, float("inf")))
                ok = merits < merit0
                best = torch.argmin(merits, dim=0)
                pick = torch.where(ok.any(dim=0), torch.argmax(ok.to(merits.dtype), dim=0), best)
                picked = torch.gather(merits, 0, pick[None])[0]
                alpha = alphas[pick] * (picked < merit0).to(merits.dtype)
            new_traj = _step(traj, alpha, dxs, dus)

        with record_function("sqp.eq_residuals"):
            g = fns.eq_residuals(new_traj, times, params)
            g_max = torch.amax(torch.abs(g), dim=(-2, -1))
            if cfg.equality_handling == "al":
                # safeguarded update: polish when nearly feasible; at large
                # violation only reward genuine progress; clamped
                do_update = (g_max < cfg.al_update_threshold) | (g_max < cfg.al_decrease * g_prev)
                lam = torch.where(do_update[..., None, None], lam + cfg.rho * g, lam)
                lam = torch.clamp(lam, -cfg.lam_max, cfg.lam_max)
        return new_traj, lam, g_max, (lq.cost, g_max, lq.defect_norm, alpha)

    def solve(t0, x0, init_traj: Trajectory, params, lam) -> SqpSolution:
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = _times(t0, x0, cfg)
        alphas = torch.tensor(cfg.alphas, dtype=x0.dtype, device=dev)
        traj, stats = init_traj, None
        g_prev = (torch.amax(torch.abs(fns.eq_residuals(init_traj, times, params)), dim=(-2, -1))
                  if cfg.equality_handling == "al" else None)
        for _ in range(cfg.sqp_iterations):
            traj, lam, g_prev, stats = sqp_iteration(traj, lam, g_prev, times, params, x0,
                                                     alphas)
        cost, g_norm, defect_norm, alpha = stats
        return SqpSolution(traj=traj, lam=lam, cost=cost, g_norm=g_norm,
                           defect_norm=defect_norm, step_size=alpha,
                           iterations=cfg.sqp_iterations)

    return solve


def make_staged_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                           device="cuda") -> Callable:
    """Per-phase-timed SQP solve (the diagnostic twin of `make_sqp_solver`,
    projection path only). Each phase ends with `torch.cuda.synchronize()` on
    the card (JAX's `block_until_ready`), so its wall time includes its device
    time; on the CPU nothing is asynchronous. The filter line search
    evaluates all steps at once (the same rule as the two-stage ladder).

    Returns solve(t0, x0, init_traj, params, lam) -> (SqpSolution, PhaseTimings)."""
    _check_config(cfg)
    if cfg.equality_handling != "projection":
        raise ValueError("staged solver only implements the projection path")
    dev = resolve_device(device)
    fns = _lq_functions(ocp, flow, bp, cfg)
    rho_lq = _rho_lq(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        return out, time.perf_counter() - t0

    def f_project(lq):
        reduced, proj = project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)
        return levenberg_damp(reduced, cfg.reg), proj

    def f_riccati(reduced, proj, dx0):
        dxs, dzs = _solve_lq(reduced, dx0, cfg)
        return dxs, recover_controls(proj, dxs, dzs)

    def f_linesearch(traj, times, params, c0, v0, dxs, dus, alphas):
        cs, vs = fns.candidate_perf(_candidates(traj, alphas, dxs, dus), times, params)
        ok = filter_accept(c0, v0, cs, vs, cfg.filter_g_max, cfg.filter_g_min)
        alpha = _first_true(alphas, ok)
        new_traj = _step(traj, alpha, dxs, dus)
        g = fns.eq_residuals(new_traj, times, params)
        return new_traj, alpha, torch.amax(torch.abs(g))

    def solve(t0, x0, init_traj: Trajectory, params, lam):
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = _times(t0, x0, cfg)
        alphas = torch.tensor(cfg.alphas, dtype=x0.dtype, device=dev)
        traj = init_traj
        spent = dict(lq=0.0, projection=0.0, riccati=0.0, linesearch=0.0)
        alpha = g_max = torch.zeros((), dtype=x0.dtype, device=dev)
        lq = None
        for _ in range(cfg.sqp_iterations):
            lq, t = timed(fns.lq_approximation, traj, times, params, lam, rho_lq)
            spent["lq"] += t
            (reduced, proj), t = timed(f_project, lq)
            spent["projection"] += t
            (dxs, dus), t = timed(f_riccati, reduced, proj, x0 - traj.xs[0])
            spent["riccati"] += t
            (traj, alpha, g_max), t = timed(f_linesearch, traj, times, params, lq.cost_pure,
                                            lq.viol, dxs, dus, alphas)
            spent["linesearch"] += t
        d = fns.defects(traj, times)
        sol = SqpSolution(traj=traj, lam=lam, cost=lq.cost, g_norm=g_max,
                          defect_norm=torch.amax(torch.abs(d)), step_size=alpha,
                          iterations=cfg.sqp_iterations)
        return sol, PhaseTimings(**spent)

    return solve
