"""SQP solver, plain PyTorch and eager.

A frozen copy of the port's `solver/sqp.py` (`SqpIteration`, the eager
`make_sqp_solver`) with the CUDA graphs, the staged solver and the
associative-scan Riccati pair taken out, and the LQ solve and the FK pass
always in their plain versions. Per iteration: the batched LQ
approximation, the equality projection + relative Levenberg damping, the
Riccati solve and rollout, control recovery, the ocs2 filter line search
(the two largest steps first, the rest of the ladder when both fail) and
the step.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, NamedTuple

import torch

from mpcbench.reference.ocp.base import BarrierParams
from mpcbench.reference.ops.riccati import riccati_rollout
from mpcbench.reference.solver.linesearch import filter_accept
from mpcbench.reference.solver.projection import project_lq, recover_controls
from mpcbench.reference.solver.riccati import levenberg_damp
from mpcbench.reference.solver.transcription import Trajectory, make_lq_functions
from mpcbench.reference.utils.device import resolve_device


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
    rollout_backend: str = "plain"
    # the same for the FK + velocity tree pass of the RK4 tail and the line
    # search (ops/fkvel.py)
    flow_backend: str = "plain"


def _check_config(cfg: SqpSolverConfig) -> None:
    for name, allowed in (("equality_handling", ("projection", "al")),
                          ("line_search", ("filter", "merit")),
                          ("sensitivity", ("node", "midpoint", "exact"))):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"SqpSolverConfig.{name}={getattr(cfg, name)!r}: expected one of "
                             f"{allowed}")


def model_flow_batch(ocp, cfg: SqpSolverConfig):
    """The model's `flow_map_batch` with `cfg.flow_backend` (the plain FK
    pass), or None when the model has none."""
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
    """The damped LQ's (dxs, dus) by the plain Riccati solve."""
    if cfg.parallel_riccati:
        raise ValueError("the reference has no associative-scan Riccati pair")
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

    `make_sqp_solver` runs the three in order."""

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


def ladder_choices(nominal, surely, possibly) -> list[int | None]:
    """The filter's possible picks over the step ladder: indices of the
    candidates that may be the first accepted one, the nominal pick first;
    None stands for no step (alpha 0). `surely` / `possibly` are the
    acceptance with the candidates' performance moved against / for them."""
    surely, possibly = (surely & nominal).tolist(), (possibly | nominal).tolist()
    nominal = nominal.tolist()
    picks: list[int | None] = []
    for j, maybe in enumerate(possibly):
        if maybe:
            picks.append(j)
        if surely[j]:
            break
    else:
        picks.append(None)
    first = next((j for j, ok in enumerate(nominal) if ok), None)
    return [first] + [j for j in picks if j != first]


class Leaf(NamedTuple):
    """One solution of `solve.branches`: the ladder index picked in each
    iteration (None: no step), and the least of the tolerances at which
    every pick on its path is possible (0 for the nominal solution)."""
    solution: SqpSolution
    picks: tuple
    need: float


def make_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, *,
                    device="cpu") -> Callable:
    """Returns solve(t0, x0, init_traj, params, lam) -> SqpSolution, run
    eagerly on `device`, with `solve.branches` beside it."""
    dev = resolve_device(device)
    it = SqpIteration(ocp, flow, bp, cfg)

    def branches(t0, x0, init_traj: Trajectory, params, lam, tols, max_leaves: int = 8,
                 min_split: float = 0.0) -> list[Leaf]:
        """The solutions that the filter line search reaches when each of its
        decisions may fall either way within a tolerance: a candidate whose
        cost (over max(1, |c0|)) and violation (relative) lie within the
        tolerance of flipping its acceptance may be accepted or rejected.
        Each leaf carries the least of `tols` that reaches it. A branch is
        taken only where it moves the iterate by `min_split` or more, in the
        policy gap's measure (each column over max(1, its largest |value|)):
        near convergence every step of the ladder is a tie, and none
        matters. The nominal solution (every decision as `solve` takes it)
        comes first, then the others, the least tolerance and the earliest
        iteration first, at most `max_leaves` in all. A single instance
        (x0 [nx]) on the filter and projection path."""
        if not it.filter or it.al or x0.dim() != 1:
            raise ValueError("branches: one instance, filter line search, projection")
        tols = sorted(float(t) for t in tols)
        times = _times(t0, x0, cfg)
        alphas = it.alphas(x0)
        ladder = [float(a) for a in cfg.alphas]
        zero = torch.zeros((), dtype=x0.dtype, device=x0.device)
        leaves: list[Leaf] = []
        pending: list = []
        order = itertools.count()

        def spread(traj, head) -> float:
            """How far a unit step moves the iterate, in the gap's measure."""
            return max(float((torch.abs(d).amax(dim=0) / torch.clamp(
                torch.abs(v).amax(dim=0), min=1.0)).max())
                for d, v in ((head.dxs, traj.xs), (head.dus, traj.us)))

        def step(k, traj, head, j, picks, need):
            alpha = zero if j is None else alphas[j]
            new_traj = _step(traj, alpha, head.dxs, head.dus)
            g_max = torch.amax(torch.abs(it.fns.eq_residuals(new_traj, times, params)))
            run(k + 1, new_traj, (head.cost, g_max, head.defect_norm, alpha), picks + [j], need)

        def run(k, traj, stats, picks, need):
            """Follow the nominal decisions from iteration k to the end; put
            the other possible picks on the way aside."""
            while k < cfg.sqp_iterations:
                head = it.head(traj, lam, times, params, x0, alphas)
                cs, vs = it.fns.candidate_perf(_candidates(traj, alphas, head.dxs, head.dus),
                                               times, params)
                scale = torch.clamp(torch.abs(head.c0), min=1.0)

                def accept(shift):
                    return filter_accept(head.c0, head.v0, cs + shift * scale,
                                         vs * (1.0 + shift), cfg.filter_g_max, cfg.filter_g_min)

                nominal = accept(0.0)
                first = ladder_choices(nominal, nominal, nominal)[0]
                tag: dict = {}
                for tol in tols:
                    for j in ladder_choices(nominal, accept(tol), accept(-tol)):
                        tag.setdefault(j, tol)
                tag.pop(first, None)
                if tag:
                    size = spread(traj, head)
                    a_first = 0.0 if first is None else ladder[first]
                    for j, tol in tag.items():
                        if abs((0.0 if j is None else ladder[j]) - a_first) * size >= min_split:
                            heapq.heappush(pending, (max(need, tol), k, next(order), j, traj,
                                                     head, picks))
                alpha = zero if first is None else alphas[first]
                new_traj = _step(traj, alpha, head.dxs, head.dus)
                g_max = torch.amax(torch.abs(it.fns.eq_residuals(new_traj, times, params)))
                traj, stats = new_traj, (head.cost, g_max, head.defect_norm, alpha)
                picks = picks + [first]
                k += 1
            leaves.append(Leaf(it.solution(traj, lam, stats), tuple(picks), need))

        run(0, init_traj, None, [], 0.0)
        while pending and len(leaves) < max_leaves:
            need, k, _, j, traj, head, picks = heapq.heappop(pending)
            step(k, traj, head, j, picks, need)
        return leaves

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

    solve.branches = branches
    return solve
