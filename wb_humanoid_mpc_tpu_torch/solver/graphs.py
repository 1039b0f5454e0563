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

The 2-D sharded solve (`make_sharded_sqp_solver`, `GraphedShardedSolve`)
is captured the same way, as JAX jits it (`shard_map` inside `jax.jit`):
its iteration once, replayed for each SQP iteration, and its final gathers
once. Its collectives decide the cut (`ShardedGraphSet`): on `gloo`, one
graph for each part between two collectives, the collectives run between
the replays on static buffers; on `nccl`, one graph an iteration and one
for the gathers, the collectives inside them.

With `capture=False` the same pieces run on the same buffers, eagerly and in
the same order: the CPU tests hold that runner against the eager solve.
"""

from __future__ import annotations

import copy
import functools
import time

import torch

from wb_humanoid_mpc_tpu_torch.solver.sqp import PhaseTimings
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils import trace
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
                if piece.when_needed:
                    with trace.span("ladder_read"):
                        needed = bool(self.head.need_any)
                    if not needed:
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
        with trace.span("load"):
            s.load(t0, x0, init_traj, params, lam)
        trace.device_end("upload")
        return s

    def _solution(self, s):
        """The solution's copies out of the static buffers."""
        trace.device_start("download")
        return s.solution(self.iterations)

    def __call__(self, t0, x0, init_traj: Trajectory, params, lam):
        s = self._loaded(t0, x0, init_traj, params, lam)
        s.run(self.iterations)
        return self._solution(s)

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
        return self._solution(s), PhaseTimings(**spent)


class _ProgramGraphs(PieceGraphs):
    """One program of the sharded solve (`ShardedSqp.iteration` or `.final`:
    parts with collectives between them) on the state dict `s`, whose
    inputs are static buffers. Each part copies what it sends into a
    static buffer of its own, and each collective writes a static buffer
    that the next part reads (a reduction its input, in place), so every
    address a graph reads was fixed before its capture. With `split`, each
    part is a piece and each collective an eager piece between their
    replays (`gloo`, which stages CUDA tensors through the host, a round
    trip a capture refuses); without, the whole program is one piece, its
    collectives captured inside it (`nccl`). `carry` runs at the end of the
    last part."""

    def __init__(self, sqp, program, s: dict, capture: bool, split: bool, what: str,
                 carry=None):
        super().__init__(sqp.device, capture)
        self.sqp, self.s, self.what = sqp, s, what
        self.send: dict[str, torch.Tensor] = {}
        self.recv: dict[str, torch.Tensor] = {}
        steps = []
        for i, (part, exchanges) in enumerate(program):
            last = carry if i == len(program) - 1 else None
            steps.append(Piece(part.__name__.lstrip("_"),
                               functools.partial(self._part, part, exchanges, last)))
            steps += [Piece(f"{ex.op} {ex.key}", functools.partial(self._exchange, ex),
                            eager=split) for ex in exchanges]
        self.segments = sum(not p.eager for p in steps) if split else 1
        self.pieces = steps if split else [Piece("program", functools.partial(_run_all, steps))]

    def _part(self, part, exchanges, carry) -> None:
        sends = part(self.s)
        for ex in exchanges:
            t = sends[ex.key]
            if ex.key not in self.send:   # the first (eager) run allocates
                self.send[ex.key] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            self.send[ex.key].copy_(t)
        if carry is not None:
            carry()

    def _exchange(self, ex) -> None:
        t = self.send[ex.key]
        if ex.key not in self.recv:
            self.recv[ex.key] = self.sqp.exchange_out(ex, t)
        self.s[ex.key] = self.sqp.exchange(ex, t, self.recv[ex.key])


def _run_all(pieces) -> None:
    for piece in pieces:
        piece.run()


class ShardedGraphSet:
    """Static buffers and the two programs of the sharded solve for one
    (dtype, global batch): the rank's inputs (t0 0-d, x0, xs, us, params,
    lam), the iteration's stats, the iteration (captured once and replayed
    for each SQP iteration, the counterpart of JAX's `lax.scan` over
    iterations: its last part writes the new xs, us and stats into the
    buffers) and the final gathers (which read those buffers; their result,
    `full`, is what the solution is read from)."""

    def __init__(self, sqp, t0_dtype, inputs: dict, capture: bool, split: bool):
        dev = sqp.device
        s = {k: torch.empty_like(v) for k, v in inputs.items() if k != "params"}
        s["params"] = type(inputs["params"])(*(torch.empty_like(a) for a in inputs["params"]))
        s["t0"] = torch.zeros((), dtype=t0_dtype, device=dev)
        s["alphas"] = sqp.alphas[t0_dtype]
        self.s = s
        self.stats = tuple(torch.empty(s["x0"].shape[0], dtype=t0_dtype, device=dev)
                           for _ in range(4))
        self.tails = [s["xs"].shape[2:], s["us"].shape[2:]]
        self.iteration = _ProgramGraphs(sqp, sqp.iteration, s, capture, split,
                                        "the sharded SQP iteration", carry=self._carry)
        self.final = _ProgramGraphs(sqp, sqp.final, {"xs": s["xs"], "us": s["us"],
                                                     "stats": self.stats},
                                    capture, split, "the sharded solve's gathers")

    def _carry(self) -> None:
        s = self.s
        s["xs"].copy_(s["next_xs"])
        s["us"].copy_(s["next_us"])
        for buf, value in zip(self.stats, s["stats"]):
            buf.copy_(value)

    def load(self, t0, inputs: dict) -> None:
        s = self.s
        pairs = [(k, s[k], inputs[k]) for k in ("x0", "xs", "us", "lam")]
        pairs += [(f"params.{f}", b, a) for f, b, a in
                  zip(s["params"]._fields, s["params"], inputs["params"])]
        for name, buf, src in pairs:
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(f"graphed sharded solve built for {name} {tuple(buf.shape)} "
                                 f"{buf.dtype}, got {tuple(src.shape)} {src.dtype}")
        s["t0"].fill_(t0)
        for _, buf, src in pairs:
            buf.copy_(src)

    def run(self, iterations: int) -> None:
        """`iterations` SQP iterations, then the gathers. The first call of
        each program is its warm-up (the first iteration; the gathers), then
        its capture."""
        it, final = self.iteration, self.final
        todo = iterations
        if it.capture and not it.graphs:
            it._first_run()
            todo -= 1
        for _ in range(todo):
            for piece in it.pieces:
                it._play(piece)
        if final.capture and not final.graphs:
            final._first_run()
        else:
            for piece in final.pieces:
                final._play(piece)

    def report(self) -> dict:
        """Graphs, segments, warm-up and capture seconds, capture memory of
        both programs."""
        progs = (self.iteration, self.final)
        return dict(graphs=sum(len(p.graphs) for p in progs),
                    segments={p.what: p.segments for p in progs},
                    eager_collectives=sum(q.eager for p in progs for q in p.pieces),
                    warmup_s=sum(p.warmup_s or 0.0 for p in progs),
                    capture_s=sum(p.capture_s or 0.0 for p in progs),
                    pool_bytes=sum(p.pool_bytes or 0 for p in progs))


class GraphedShardedSolve:
    """solve(t0, x0s, init_traj, params, lam) -> SqpSolution of the sharded
    solve over CUDA graphs (`make_sharded_sqp_solver`'s default on the
    card), one `ShardedGraphSet` per (dtype, global batch). `split` (the
    graphs cut at every collective) follows the mesh's backend: split on
    `gloo`, collectives inside the graphs on `nccl`. `capture=False` runs
    the same pieces on the same buffers eagerly, on any device (the CPU
    tests)."""

    def __init__(self, sqp, *, capture: bool = True, split: bool | None = None):
        if capture:
            require_cuda(sqp.device)
        self.sqp, self.capture = sqp, capture
        self.split = sqp.backend != "nccl" if split is None else split
        self.sets: dict[tuple, ShardedGraphSet] = {}

    def __call__(self, t0, x0s, init_traj: Trajectory, params, lam):
        B = self.sqp.check(x0s, init_traj)
        inputs = self.sqp.local_inputs(x0s, init_traj, params, lam)
        key = (x0s.dtype, B)
        gs = self.sets.get(key)
        if gs is None:
            gs = self.sets[key] = ShardedGraphSet(self.sqp, x0s.dtype, inputs, self.capture,
                                                  self.split)
        gs.load(t0, inputs)
        gs.run(self.sqp.cfg.sqp_iterations)
        return self.sqp.solution(gs.final.s["full"].clone(), gs.tails, lam)
