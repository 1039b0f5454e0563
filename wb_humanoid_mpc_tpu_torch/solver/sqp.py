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

JAX runs a whole solve as one XLA program under `jax.jit`. The port splits
an iteration at its only host sync (`SqpIteration`: head, the filter's lower
ladder, tail) and, on a CUDA device, captures the pieces into CUDA graphs
once per problem shape and replays them on every call (`solver/graphs.py`);
`make_sqp_solver(..., graphs=False)` is the eager twin. The staged solver
captures each of its phases into a graph of its own, so that each is timed
apart, as JAX jits each.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

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


def _take(alphas, idx):
    """alphas[idx] for an index tensor of any shape, by `gather`: indexing
    with a CUDA index tensor reads the device, which a CUDA graph refuses."""
    return alphas.gather(0, idx.reshape(-1)).reshape(idx.shape)


def _first_true(alphas, ok):
    """Per instance, the first (largest) alpha whose candidate is accepted,
    or 0 when none is: ok [C, *batch] -> [*batch]."""
    return _take(alphas, torch.argmax(ok.to(alphas.dtype), dim=0)) * ok.any(dim=0).to(alphas.dtype)


class IterationHead(NamedTuple):
    """What the first part of an iteration leaves for the rest: the LQ's
    stats, the step (dxs, dus) and, on the filter path, the top-2 candidates'
    acceptance; on the merit path, the accepted alpha."""
    cost: torch.Tensor
    defect_norm: torch.Tensor
    c0: torch.Tensor
    v0: torch.Tensor
    dxs: torch.Tensor
    dus: torch.Tensor
    ok_hi: torch.Tensor | None = None     # [2, *batch] (filter)
    need_lo: torch.Tensor | None = None   # [*batch]: accepted neither top step (filter)
    need_any: torch.Tensor | None = None  # 0-d: some instance needs the lower ladder (filter)
    alpha: torch.Tensor | None = None     # [*batch] (merit)


class SqpIteration:
    """One SQP iteration, split at its only host sync, the filter ladder's
    branch (JAX takes it with `lax.cond` on the device):

      head  the LQ approximation, its solve (projection + damping + K1, or
            the AL path's LQ) and the top-2 candidate sweep (filter) or the
            whole merit search (merit);
      low   the rest of the ladder, for the instances that accepted neither
            top step; run only when some instance needs it;
      tail  the accepted step, the equality residuals and the AL update.

    `make_sqp_solver` runs the three in order, eagerly or as CUDA graphs
    (`solver/graphs.py`); either way, one iteration computes the same
    operations on the same values."""

    N_HI = 2   # the filter's first sweep: the two largest steps

    def __init__(self, ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig):
        _check_config(cfg)
        self.cfg = cfg
        self.fns = _lq_functions(ocp, flow, bp, cfg)
        self.rho_lq = _rho_lq(cfg)
        self.filter = cfg.line_search == "filter"
        self.al = cfg.equality_handling == "al"
        self._alphas: dict = {}

    def alphas(self, like: torch.Tensor) -> torch.Tensor:
        """The step ladder on like's device and dtype, made once."""
        key = (like.device, like.dtype)
        if key not in self._alphas:
            self._alphas[key] = torch.tensor(self.cfg.alphas, dtype=like.dtype,
                                              device=like.device)
        return self._alphas[key]

    def merit(self, traj, times, params, lam):
        cfg = self.cfg
        c, _ = self.fns.total_cost(traj, times, params, lam, cfg.rho)
        d = self.fns.defects(traj, times)
        return c + cfg.defect_weight * torch.sum(torch.abs(d), dim=(-2, -1))

    def initial_g(self, traj, times, params) -> torch.Tensor:
        """max |g| of the initial trajectory: the AL update's first g_prev."""
        return torch.amax(torch.abs(self.fns.eq_residuals(traj, times, params)), dim=(-2, -1))

    def _try_alphas(self, head, traj, times, params, a):
        cs, vs = self.fns.candidate_perf(_candidates(traj, a, head.dxs, head.dus), times, params)
        return filter_accept(head.c0, head.v0, cs, vs, self.cfg.filter_g_max,
                             self.cfg.filter_g_min)

    def head(self, traj, lam, times, params, x0, alphas) -> IterationHead:
        cfg, fns = self.cfg, self.fns
        lq = fns.lq_approximation(traj, times, params, lam, self.rho_lq)
        dx0 = x0 - traj.xs[..., 0, :]
        if not self.al:
            reduced, proj = project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)
            reduced = levenberg_damp(reduced, cfg.reg)
            dxs, dzs = _solve_lq(reduced, dx0, cfg)
            dus = recover_controls(proj, dxs, dzs)
        else:
            # the unprojected LQ (nu = 35 on humanoid23) through K1
            dxs, dus = _solve_lq(levenberg_damp(lq, cfg.reg), dx0, cfg)
        head = IterationHead(cost=lq.cost, defect_norm=lq.defect_norm, c0=lq.cost_pure,
                             v0=lq.viol, dxs=dxs, dus=dus)
        if self.filter:
            # ocs2 FilterLinesearch: the largest accepted step wins. The
            # baseline (c0, v0) comes with the LQ pass; the top-2 steps
            # are tried first. Every instance of a batch has its own.
            ok_hi = self._try_alphas(head, traj, times, params, alphas[:self.N_HI])
            need_lo = ~ok_hi.any(dim=0)
            return head._replace(ok_hi=ok_hi, need_lo=need_lo, need_any=need_lo.any())
        # AL merit: all steps at once (one K2 launch per flow stage over
        # steps x instances x nodes); the largest step that decreases it
        merit0 = self.merit(traj, times, params, lam)
        merits = self.merit(_candidates(traj, alphas, dxs, dus), times, params, lam)
        # a candidate that produced NaN/inf must never be selected
        merits = torch.where(torch.isfinite(merits), merits,
                             torch.full_like(merits, float("inf")))
        ok = merits < merit0
        best = torch.argmin(merits, dim=0)
        pick = torch.where(ok.any(dim=0), torch.argmax(ok.to(merits.dtype), dim=0), best)
        picked = torch.gather(merits, 0, pick[None])[0]
        return head._replace(alpha=_take(alphas, pick) * (picked < merit0).to(merits.dtype))

    def low(self, head: IterationHead, traj, times, params, alphas) -> torch.Tensor:
        """The rest of the filter ladder, [C - 2, *batch]: it counts only for
        the instances that accepted neither top step."""
        return self._try_alphas(head, traj, times, params, alphas[self.N_HI:]) & head.need_lo

    def no_low(self, head: IterationHead, alphas) -> torch.Tensor:
        """`low`'s answer when no instance needs the rest of the ladder."""
        return torch.zeros(alphas.shape[0] - self.N_HI, *head.need_lo.shape, dtype=torch.bool,
                           device=alphas.device)

    def tail(self, head: IterationHead, ok_lo, traj, lam, g_prev, times, params, alphas):
        """(new traj, lam, max |g|, (cost, max |g|, defect norm, alpha))."""
        cfg = self.cfg
        alpha = (_first_true(alphas, torch.cat([head.ok_hi, ok_lo])) if self.filter
                 else head.alpha)
        new_traj = _step(traj, alpha, head.dxs, head.dus)
        g = self.fns.eq_residuals(new_traj, times, params)
        g_max = torch.amax(torch.abs(g), dim=(-2, -1))
        if self.al:
            # safeguarded update: polish when nearly feasible; at large
            # violation only reward genuine progress; clamped
            do_update = (g_max < cfg.al_update_threshold) | (g_max < cfg.al_decrease * g_prev)
            lam = torch.where(do_update[..., None, None], lam + cfg.rho * g, lam)
            lam = torch.clamp(lam, -cfg.lam_max, cfg.lam_max)
        return new_traj, lam, g_max, (head.cost, g_max, head.defect_norm, alpha)

    def solution(self, traj, lam, stats) -> SqpSolution:
        cost, g_norm, defect_norm, alpha = stats
        return SqpSolution(traj=traj, lam=lam, cost=cost, g_norm=g_norm,
                           defect_norm=defect_norm, step_size=alpha,
                           iterations=self.cfg.sqp_iterations)


def make_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *, device="cuda",
                    graphs: bool | None = None) -> Callable:
    """Returns solve(t0, x0, init_traj, params, lam) -> SqpSolution.

    Every tensor passed to `solve` lies on `device` (the CUDA card unless the
    caller asks for the CPU). `graphs` picks how an iteration runs: None (the
    default) as CUDA graphs on a CUDA device and eagerly on the CPU, which has
    none; True as CUDA graphs (`solver/graphs.py`: captured once per problem
    shape, replayed every call; raises on the CPU); False eagerly, the twin
    that the tests use. The graphed solve copies its inputs
    into static buffers and returns copies of its results, so a solution the
    caller holds keeps its values after the next call."""
    dev = resolve_device(device)
    it = SqpIteration(ocp, flow, bp, cfg)
    if graphs is None:
        graphs = dev.type == "cuda"
    if graphs:
        from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve

        return GraphedSqpSolve(it, dev)

    def solve(t0, x0, init_traj: Trajectory, params, lam) -> SqpSolution:
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = _times(t0, x0, cfg)
        alphas = it.alphas(x0)
        traj, stats = init_traj, None
        g_prev = it.initial_g(traj, times, params) if it.al else None
        for _ in range(cfg.sqp_iterations):
            head = it.head(traj, lam, times, params, x0, alphas)
            ok_lo = None
            if it.filter:
                # one host sync per iteration: the rest of the ladder runs
                # when some instance accepted neither top step
                ok_lo = (it.low(head, traj, times, params, alphas) if bool(head.need_any)
                         else it.no_low(head, alphas))
            traj, lam, g_prev, stats = it.tail(head, ok_lo, traj, lam, g_prev, times, params,
                                               alphas)
        return it.solution(traj, lam, stats)

    return solve


class StagedIteration(SqpIteration):
    """The staged solver's four phases, each a program of its own (JAX's
    jitted `f_lq`, `f_project`, `f_riccati` + `f_recover`, `f_linesearch`):
    `make_staged_sqp_solver` runs them eagerly or as one CUDA graph each
    (`solver/graphs.py`). The filter line search evaluates all steps at once
    (the same rule as the two-stage ladder)."""

    def lq(self, traj, times, params, lam):
        return self.fns.lq_approximation(traj, times, params, lam, self.rho_lq)

    def project(self, lq):
        reduced, proj = project_lq(lq, lq.Cx, lq.Du, lq.g_res, self.cfg.proj_eps)
        return levenberg_damp(reduced, self.cfg.reg), proj

    def riccati(self, reduced, proj, dx0):
        dxs, dzs = _solve_lq(reduced, dx0, self.cfg)
        return dxs, recover_controls(proj, dxs, dzs)

    def linesearch(self, traj, times, params, c0, v0, dxs, dus, alphas):
        cfg = self.cfg
        cs, vs = self.fns.candidate_perf(_candidates(traj, alphas, dxs, dus), times, params)
        ok = filter_accept(c0, v0, cs, vs, cfg.filter_g_max, cfg.filter_g_min)
        alpha = _first_true(alphas, ok)
        new_traj = _step(traj, alpha, dxs, dus)
        g = self.fns.eq_residuals(new_traj, times, params)
        return new_traj, alpha, torch.amax(torch.abs(g))

    def staged_solution(self, traj, lam, cost, alpha, g_max, times,
                        iterations: int) -> SqpSolution:
        d = self.fns.defects(traj, times)
        return SqpSolution(traj=traj, lam=lam, cost=cost, g_norm=g_max,
                           defect_norm=torch.amax(torch.abs(d)), step_size=alpha,
                           iterations=iterations)


def make_staged_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                           device="cuda", graphs: bool | None = None) -> Callable:
    """Per-phase-timed SQP solve (the diagnostic twin of `make_sqp_solver`,
    projection path only). Each phase ends with `torch.cuda.synchronize()` on
    the card (JAX's `block_until_ready`), so its wall time includes its device
    time; on the CPU nothing is asynchronous. `graphs` as for
    `make_sqp_solver`: on the card each phase replays a CUDA graph of its own
    (captured at the first call of a problem shape, whose first iteration
    runs eagerly), so a phase's time is its device time and one dispatch;
    graphs=False runs the phases eagerly.

    Returns solve(t0, x0, init_traj, params, lam) -> (SqpSolution, PhaseTimings)."""
    _check_config(cfg)
    if cfg.equality_handling != "projection":
        raise ValueError("staged solver only implements the projection path")
    dev = resolve_device(device)
    it = StagedIteration(ocp, flow, bp, cfg)
    if graphs is None:
        graphs = dev.type == "cuda"
    if graphs:
        from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedStagedSolve

        return GraphedStagedSolve(it, dev)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def solve(t0, x0, init_traj: Trajectory, params, lam):
        if x0.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0.device}")
        times = _times(t0, x0, cfg)
        alphas = it.alphas(x0)
        traj = init_traj
        spent = dict(lq=0.0, projection=0.0, riccati=0.0, linesearch=0.0)
        alpha = g_max = torch.zeros((), dtype=x0.dtype, device=dev)
        lq = None
        for _ in range(cfg.sqp_iterations):
            lq, t = timed(it.lq, traj, times, params, lam)
            spent["lq"] += t
            (reduced, proj), t = timed(it.project, lq)
            spent["projection"] += t
            (dxs, dus), t = timed(it.riccati, reduced, proj, x0 - traj.xs[0])
            spent["riccati"] += t
            (traj, alpha, g_max), t = timed(it.linesearch, traj, times, params, lq.cost_pure,
                                            lq.viol, dxs, dus, alphas)
            spent["linesearch"] += t
        sol = it.staged_solution(traj, lam, lq.cost, alpha, g_max, times, cfg.sqp_iterations)
        return sol, PhaseTimings(**spent)

    return solve
