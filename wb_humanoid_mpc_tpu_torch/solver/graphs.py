"""The compiled SQP solve: CUDA graphs, the port's counterpart of `jax.jit`.

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

The first call of a set runs its first iteration eagerly on a side stream
(PyTorch's warm-up before capture: it fills the lazy tensor caches of the
models and the OCP and creates the cuBLAS / cuSOLVER handles and
workspaces), B included (its answer is masked by `need_lo`, so the result is
the eager one), then captures every graph and replays the rest. Capture is
`capture_error_mode="thread_local"`: the MRT solver thread captures while
the control loop runs its controller on another stream in another thread,
which the default global mode would refuse. Python's cyclic garbage
collector is paused while capturing (a collection could destroy another
solver's graph from the capturing thread). A capture that fails raises,
naming the operation; nothing falls back to the eager solve.

A kernel wrapper counts a launch recorded into a graph in its `RECORDED`
(not `LAUNCHES`; `ops/_lib.py` keeps the counts of every registered
wrapper); each set keeps how many launches of each kernel its graphs hold
and adds them to `LAUNCHES` at every replay.

The runtime's recovery solve is the same solve at another iteration count
(`with_iterations`): it replays the same graph sets, as JAX's recovery solve
is the same program compiled for 12 iterations.

With `capture=False` the same pieces run on the same buffers, eagerly and in
the same order: the CPU tests hold that runner against the eager solve.
"""

from __future__ import annotations

import copy
import gc
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

_PKG = Path(__file__).resolve().parent.parent


class _Piece(NamedTuple):
    name: str
    run: Callable[[], None]
    when_needed: bool = False   # B: replayed only if some instance needs the lower ladder


def _failure_site(err: BaseException) -> str:
    """The innermost frame outside torch where `err` (or the error it
    followed, when ending the capture raised again) was raised: the
    operation the capture refused."""
    while err.__context__ is not None and err.__cause__ is None:
        err = err.__context__
    torch_dir = str(Path(torch.__file__).resolve().parent)
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(torch_dir) and f.filename != __file__]
    where = ""
    if frames:
        f = frames[-1]
        path = Path(f.filename)
        if path.is_relative_to(_PKG.parent):
            path = path.relative_to(_PKG.parent)
        where = f"{path}:{f.lineno} in {f.name}: {f.line} "
    return f"{where}({type(err).__name__}: {str(err).splitlines()[0] if str(err) else ''})"


class GraphSet:
    """Static buffers, pieces and (with capture) the CUDA graphs of one
    problem shape. `capture_s`, `warmup_s` and `pool_bytes` (device memory
    reserved by the capture) are None until the first call captures."""

    def __init__(self, it, x0, traj: Trajectory, params, lam, capture: bool):
        self.it, self.capture = it, capture
        cfg, dev = it.cfg, x0.device
        self.device = dev
        self.batch = tuple(x0.shape[:-1])
        self.t0 = torch.zeros((), dtype=x0.dtype, device=dev)
        self.grid = cfg.dt * torch.arange(cfg.n_nodes + 1, dtype=x0.dtype, device=dev)
        self.x0 = torch.empty_like(x0)
        self.traj = Trajectory(xs=torch.empty_like(traj.xs), us=torch.empty_like(traj.us))
        self.params = type(params)(*(torch.empty_like(a) for a in params))
        self.lam = torch.empty_like(lam)
        self.alphas = it.alphas(x0)
        self.g_prev = torch.empty(self.batch, dtype=x0.dtype, device=dev) if it.al else None
        self.ok_lo = (torch.zeros(len(cfg.alphas) - it.N_HI, *self.batch, dtype=torch.bool,
                                  device=dev) if it.filter else None)
        self.stats = tuple(torch.empty(self.batch, dtype=x0.dtype, device=dev) for _ in range(4))
        self.head = None   # the head's outputs (a graph's: static once captured)
        self.per_call = [_Piece("G0 initial g", self._initial_g)] if it.al else []
        if it.filter:
            self.per_iteration = [_Piece("A head", self._head), _Piece("B low", self._low, True),
                                  _Piece("C tail", self._tail)]
        else:
            self.per_iteration = [_Piece("AC iteration", self._head_and_tail)]
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.held: dict[str, dict[str, int]] = {}   # graph -> {wrapper module: launches}
        self.capture_s = self.warmup_s = self.pool_bytes = None

    # ---- the pieces: read and write the buffers only ----
    def _times(self):
        return (self.t0 + self.grid).expand(*self.batch, self.grid.shape[0])

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

    def run(self, iterations: int) -> None:
        todo = iterations
        if self.capture and not self.graphs:
            self._warm_up()
            self._capture_all()
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

    def _play(self, piece: _Piece) -> None:
        if not self.capture:
            piece.run()
            return
        self.graphs[piece.name].replay()
        _lib.add_replayed(self.held[piece.name])

    # ---- warm-up and capture ----
    def _capture(self, piece: _Piece, pool, stream) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _lib.recorded()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                piece.run()
        except Exception as e:
            self.graphs.clear()
            raise RuntimeError(f"CUDA graph capture of the SQP iteration's {piece.name} "
                               f"failed at {_failure_site(e)}") from e
        self.graphs[piece.name] = graph
        after = _lib.recorded()
        self.held[piece.name] = {name: n - before.get(name, 0) for name, n in after.items()
                                 if n > before.get(name, 0)}

    def _warm_up(self) -> None:
        t = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for piece in self.per_call + self.per_iteration:
                piece.run()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t

    def _capture_all(self) -> None:
        t = time.perf_counter()
        # a garbage collection during a capture could destroy an unreachable
        # graph (of a dropped solver) from this thread, a call the capture
        # refuses: collect now, and not while capturing
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(self.device)
            for piece in self.per_call + self.per_iteration:
                self._capture(piece, pool, stream)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t


class GraphedSqpSolve:
    """solve(t0, x0, init_traj, params, lam) -> SqpSolution over CUDA graphs
    (`make_sqp_solver(..., graphs=True)`), one `GraphSet` per problem shape.
    `capture=False` runs the same pieces on the same buffers eagerly, on any
    device (the CPU tests). A call runs `iterations` SQP iterations, the
    config's unless `with_iterations` set another count."""

    def __init__(self, it, device: torch.device, *, capture: bool = True):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}: pass graphs=False "
                             f"(or leave it None) to solve eagerly on the CPU")
        self.it, self.device, self.capture = it, device, capture
        self.iterations = it.cfg.sqp_iterations
        self.sets: dict[tuple, GraphSet] = {}

    def __call__(self, t0, x0, init_traj: Trajectory, params, lam):
        if x0.device != self.device or init_traj.xs.device != self.device:
            raise ValueError(f"solver built for {self.device}, got tensors on {x0.device}")
        key = (x0.device, x0.dtype, tuple(x0.shape[:-1]), self.it.cfg.n_nodes)
        s = self.sets.get(key)
        if s is None:
            s = self.sets[key] = GraphSet(self.it, x0, init_traj, params, lam, self.capture)
        s.load(t0, x0, init_traj, params, lam)
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
