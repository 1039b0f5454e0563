"""The compiled SQP solves: CUDA graphs, the port's counterpart of `jax.jit`.

JAX runs a whole solve as one XLA program, compiled once per argument shape
(`jax.jit` at every caller of `wb_humanoid_mpc_tpu/solver/sqp.py`). Here the
pieces of an SQP iteration (`SqpIteration`) are captured into CUDA graphs
(`torch.cuda.CUDAGraph`) once per problem shape and replayed on every call,
so the host issues a few replays an iteration instead of its ~12k eager
launches.

An iteration splits at its only host sync, the filter ladder's branch:

  A  `head`: LQ, projection, damping, K1, control recovery, the top-2
     candidate sweep; writes `need_lo` and zeroes the lower ladder's mask;
  B  `low`: the rest of the ladder, replayed only when the host reads that
     some instance accepted neither top step (one device-to-host read an
     iteration, as the eager solve's);
  C  `tail`: the accepted step, the residuals, the AL update; writes the new
     trajectory, multipliers and stats into the input buffers.

The merit search has no sync, so its iteration is one graph (A and C); on
the AL path one more graph computes the first g_prev once a call. A solve of
k iterations replays A, B where needed, C, k times.

A graph set serves one (device, dtype, leading batch shape, N). It holds
static buffers for t0 (a 0-d tensor: no time is baked into a graph, as JAX
traces t0), x0, the trajectory, every leaf of the node params and the
multipliers; each call copies its inputs into them, and the solution it
returns is copied out, so a solution the caller holds keeps its values after
the next call, as JAX's arrays do. The set's graphs share one memory pool.

A set is a `utils/graphs.py::PieceGraphs`, which warms up, captures,
replays and counts the kernel launches its graphs hold. The first call of
a set runs its first iteration eagerly on a side stream (the warm-up), B
included (its answer is masked by `need_lo`, so the result is the eager
one), then captures every graph and replays the rest. A capture that fails
raises, naming the operation; nothing falls back to the eager solve.

The runtime's recovery solve is the same solve at another iteration count
(`with_iterations`): it replays the same graph sets, as JAX's recovery solve
is the same program compiled for 12 iterations.

The staged solver (`make_staged_sqp_solver`) is captured the same way,
one graph a phase (`StagedGraphSet`: lq, projection, riccati, linesearch),
so that each phase is timed apart, as JAX jits each phase.

With `capture=False` the same pieces run on the same buffers, eagerly and in
the same order: the CPU tests hold that runner against the eager solve.
"""

from __future__ import annotations

import copy
import time

import torch

from wb_humanoid_mpc_tpu_torch.solver.sqp import PhaseTimings
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils.graphs import Piece, PieceGraphs, require_cuda


class _SolveBuffers(PieceGraphs):
    """Static buffers of a solve's inputs for one problem shape: t0 (0-d),
    x0, the trajectory, every leaf of the node params, the multipliers, and
    the step ladder."""

    def __init__(self, it, x0, traj: Trajectory, params, lam, capture: bool):
        super().__init__(x0.device, capture)
        self.it = it
        cfg, dev = it.cfg, x0.device
        self.batch = tuple(x0.shape[:-1])
        self.t0 = torch.zeros((), dtype=x0.dtype, device=dev)
        self.grid = cfg.dt * torch.arange(cfg.n_nodes + 1, dtype=x0.dtype, device=dev)
        self.x0 = torch.empty_like(x0)
        self.traj = Trajectory(xs=torch.empty_like(traj.xs), us=torch.empty_like(traj.us))
        self.params = type(params)(*(torch.empty_like(a) for a in params))
        self.lam = torch.empty_like(lam)
        self.alphas = it.alphas(x0)

    def _times(self):
        return (self.t0 + self.grid).expand(*self.batch, self.grid.shape[0])

    def load(self, t0, x0, traj: Trajectory, params, lam) -> None:
        pairs = [("x0", self.x0, x0), ("init_traj.xs", self.traj.xs, traj.xs),
                 ("init_traj.us", self.traj.us, traj.us), ("lam", self.lam, lam)]
        pairs += [(f"params.{f}", b, a) for f, b, a in zip(params._fields, self.params, params)]
        for name, buf, src in pairs:
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(f"graphed solve built for {name} {tuple(buf.shape)} "
                                 f"{buf.dtype}, got {tuple(src.shape)} {src.dtype}")
        self.t0.fill_(t0)
        for _, buf, src in pairs:
            buf.copy_(src)


class GraphSet(_SolveBuffers):
    """Static buffers, pieces and (with capture) the CUDA graphs of one
    problem shape of the SQP solve."""

    what = "the SQP iteration"

    def __init__(self, it, x0, traj: Trajectory, params, lam, capture: bool):
        super().__init__(it, x0, traj, params, lam, capture)
        cfg, dev = it.cfg, x0.device
        self.g_prev = torch.empty(self.batch, dtype=x0.dtype, device=dev) if it.al else None
        self.ok_lo = (torch.zeros(len(cfg.alphas) - it.N_HI, *self.batch, dtype=torch.bool,
                                  device=dev) if it.filter else None)
        self.stats = tuple(torch.empty(self.batch, dtype=x0.dtype, device=dev) for _ in range(4))
        self.head = None   # the head's outputs (a graph's: static once captured)
        self.per_call = [Piece("G0 initial g", self._initial_g)] if it.al else []
        if it.filter:
            self.per_iteration = [Piece("A head", self._head), Piece("B low", self._low, True),
                                  Piece("C tail", self._tail)]
        else:
            self.per_iteration = [Piece("AC iteration", self._head_and_tail)]
        self.pieces = self.per_call + self.per_iteration

    # ---- the pieces: read and write the buffers only ----
    def _initial_g(self):
        self.g_prev.copy_(self.it.initial_g(self.traj, self._times(), self.params))

    def _head(self):
        self.head = self.it.head(self.traj, self.lam, self._times(), self.params, self.x0,
                                 self.alphas)
        if self.it.filter:
            self.ok_lo.zero_()

    def _low(self):
        self.ok_lo.copy_(self.it.low(self.head, self.traj, self._times(), self.params,
                                     self.alphas))

    def _tail(self):
        traj, lam, g_max, stats = self.it.tail(self.head, self.ok_lo, self.traj, self.lam,
                                               self.g_prev, self._times(), self.params,
                                               self.alphas)
        self.traj.xs.copy_(traj.xs)
        self.traj.us.copy_(traj.us)
        if self.it.al:
            self.lam.copy_(lam)
            self.g_prev.copy_(g_max)
        for buf, value in zip(self.stats, stats):
            buf.copy_(value)

    def _head_and_tail(self):
        self._head()
        self._tail()

    # ---- a call ----
    def run(self, iterations: int) -> None:
        todo = iterations
        if self.capture and not self.graphs:
            self._first_run()
            todo -= 1
        else:
            for piece in self.per_call:
                self._play(piece)
        for _ in range(todo):
            for piece in self.per_iteration:
                if piece.when_needed and not bool(self.head.need_any):
                    continue
                self._play(piece)

    def solution(self, iterations: int):
        sol = self.it.solution(Trajectory(xs=self.traj.xs.clone(), us=self.traj.us.clone()),
                               self.lam.clone(), tuple(s.clone() for s in self.stats))
        return sol._replace(iterations=iterations)


class StagedGraphSet(_SolveBuffers):
    """The staged solver's phases (`StagedIteration`) on the static buffers
    of one problem shape, one graph a phase: `lq`, `projection`, `riccati`
    (the LQ solve, K1, and the control recovery) and `linesearch` (every
    candidate through K2, the filter, the step, the residuals), as JAX jits
    each phase of its staged solver. Each phase's time is its replay and one
    `torch.cuda.synchronize`: its device time and one dispatch, as JAX's
    `block_until_ready` around a jitted program gives.

    The phases hand each other their outputs in attributes, which a capture
    rebinds to tensors its graph fills only when replayed. What the solution
    reads (the cost, the step, the residual norm) is copied into `kept`, a
    static buffer each, allocated by the first (eager) run: after a first
    call of one iteration, which runs eagerly and then only captures, they
    hold the eager iteration's values."""

    what = "the staged SQP iteration"

    def __init__(self, it, x0, traj: Trajectory, params, lam, capture: bool):
        super().__init__(it, x0, traj, params, lam, capture)
        self.lq = self.reduced = self.proj = self.dxs = self.dus = None
        self.kept: dict[str, torch.Tensor] = {}
        self.pieces = [Piece("lq", self._lq), Piece("projection", self._project),
                       Piece("riccati", self._riccati), Piece("linesearch", self._linesearch)]

    def _keep(self, name: str, value: torch.Tensor) -> None:
        if name not in self.kept:
            self.kept[name] = torch.empty_like(value)
        self.kept[name].copy_(value)

    def _lq(self):
        self.lq = self.it.lq(self.traj, self._times(), self.params, self.lam)
        self._keep("cost", self.lq.cost)

    def _project(self):
        self.reduced, self.proj = self.it.project(self.lq)

    def _riccati(self):
        self.dxs, self.dus = self.it.riccati(self.reduced, self.proj, self.x0 - self.traj.xs[0])

    def _linesearch(self):
        traj, alpha, g_max = self.it.linesearch(
            self.traj, self._times(), self.params, self.lq.cost_pure, self.lq.viol, self.dxs,
            self.dus, self.alphas)
        self.traj.xs.copy_(traj.xs)
        self.traj.us.copy_(traj.us)
        self._keep("alpha", alpha)
        self._keep("g_max", g_max)

    def run(self, iterations: int) -> dict[str, float]:
        """Seconds by phase over the iterations: on the first call the eager
        warm-up's (the first iteration), then the replays'."""
        spent = dict.fromkeys((p.name for p in self.pieces), 0.0)
        todo = iterations
        if self.capture and not self.graphs:
            spent.update(self._first_run())
            todo -= 1
        for _ in range(todo):
            for piece in self.pieces:
                t = time.perf_counter()
                self._play(piece)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                spent[piece.name] += time.perf_counter() - t
        return spent

    def solution(self, iterations: int):
        traj = Trajectory(xs=self.traj.xs.clone(), us=self.traj.us.clone())
        k = self.kept
        return self.it.staged_solution(traj, self.lam.clone(), k["cost"].clone(),
                                       k["alpha"].clone(), k["g_max"].clone(), self._times(),
                                       iterations)


class GraphedSqpSolve:
    """solve(t0, x0, init_traj, params, lam) -> SqpSolution over CUDA graphs
    (`make_sqp_solver(..., graphs=True)`), one `GraphSet` per problem shape.
    `capture=False` runs the same pieces on the same buffers eagerly, on any
    device (the CPU tests). A call runs `iterations` SQP iterations, the
    config's unless `with_iterations` set another count."""

    graph_set = GraphSet

    def __init__(self, it, device: torch.device, *, capture: bool = True):
        if capture:
            require_cuda(device)
        self.it, self.device, self.capture = it, device, capture
        self.iterations = it.cfg.sqp_iterations
        self.sets: dict[tuple, GraphSet] = {}

    def _loaded(self, t0, x0, init_traj: Trajectory, params, lam):
        """The graph set of the problem's shape, its buffers loaded."""
        if x0.device != self.device or init_traj.xs.device != self.device:
            raise ValueError(f"solver built for {self.device}, got tensors on {x0.device}")
        key = (x0.device, x0.dtype, tuple(x0.shape[:-1]), self.it.cfg.n_nodes)
        s = self.sets.get(key)
        if s is None:
            s = self.sets[key] = self.graph_set(self.it, x0, init_traj, params, lam,
                                                self.capture)
        s.load(t0, x0, init_traj, params, lam)
        return s

    def __call__(self, t0, x0, init_traj: Trajectory, params, lam):
        s = self._loaded(t0, x0, init_traj, params, lam)
        s.run(self.iterations)
        return s.solution(self.iterations)

    def with_iterations(self, iterations: int) -> GraphedSqpSolve:
        """The same solve at another number of SQP iterations, sharing this
        one's graph sets: an iteration's graphs do not depend on how many
        iterations a call runs, so whichever of the two is called first
        captures them for both."""
        other = copy.copy(self)   # shares `sets`
        other.iterations = iterations
        return other

    def release(self) -> None:
        """Drop every graph set (its graphs, buffers and pool), for every
        solve that shares them."""
        self.sets.clear()


class GraphedStagedSolve(GraphedSqpSolve):
    """solve(...) -> (SqpSolution, PhaseTimings) over CUDA graphs
    (`make_staged_sqp_solver(..., graphs=True)`), one `StagedGraphSet` per
    problem shape; `capture=False` as for `GraphedSqpSolve`."""

    graph_set = StagedGraphSet

    def __call__(self, t0, x0, init_traj: Trajectory, params, lam):
        s = self._loaded(t0, x0, init_traj, params, lam)
        spent = s.run(self.iterations)
        return s.solution(self.iterations), PhaseTimings(**spent)
