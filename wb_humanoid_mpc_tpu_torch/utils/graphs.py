"""CUDA graphs, the port's counterpart of `jax.jit`: the capture machinery
that every graphed program of the port shares.

JAX compiles a function once per argument shape and runs it as one program.
The port records the PyTorch launches of such a program into CUDA graphs
(`torch.cuda.CUDAGraph`) once per shape and replays them, so the host issues
one replay instead of hundreds of launches. A program is a list of pieces,
callables that read and write static buffers that its owner keeps (its
inputs are copied into them, its outputs stay in them); `PieceGraphs` runs
them eagerly (`capture=False`, the CPU tests) or captures one graph a piece
into one memory pool of its own and replays it. `GraphedFunction` is the
one-piece case: a function of fixed-shape tensors, one graph per (dtype,
shapes) of its arguments (the MRT controllers' feed-forward, the dummy
plant's RK4 step). `solver/graphs.py` builds the SQP solves on `PieceGraphs`.

The first run of a program is the warm-up (PyTorch's rule before a
capture): each piece runs once eagerly on a side stream, which fills the
lazy tensor caches of the models and the OCP and creates the cuBLAS /
cuSOLVER handles and workspaces; then every piece is captured. Capture is
`capture_error_mode="thread_local"`: the MRT solver thread captures or
replays its solve while the control loop runs its controller in another
thread, which the default global mode would refuse. One capture runs at a
time in a process (`_CAPTURING`): a capture pauses Python's cyclic garbage
collector (a collection could destroy another graph from the capturing
thread, a call the capture refuses), synchronizes the device and counts the
kernel launches it records, all of which are process-wide. The warm-up
needs none of these and runs outside the lock, so a thread's first run
waits for another thread's capture only, not for its warm-up. A capture
that fails raises, naming the operation; nothing falls back to eager.

A kernel wrapper counts a launch recorded into a graph in its `RECORDED`
(`ops/_lib.py`); each graph keeps how many launches of each kernel it holds
and adds them to `LAUNCHES` at every replay.
"""

from __future__ import annotations

import gc
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib

_PKG = Path(__file__).resolve().parent.parent
_CAPTURING = threading.Lock()   # one capture at a time in a process


class Piece(NamedTuple):
    name: str
    run: Callable[[], None]
    when_needed: bool = False   # replayed only when its program asks (the SQP's lower ladder)


def require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}: pass graphs=False "
                         f"(or leave it None) to run eagerly on the CPU")


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


class PieceGraphs:
    """The pieces of one program (`self.pieces`, in order) and, with
    `capture`, their CUDA graphs in one memory pool, captured on `stream`
    (a new stream when None). `warmup_s`, `capture_s` and `pool_bytes`
    (device memory reserved by the capture) are None until the first run
    captures. A subclass names its program in `what` (None for one piece,
    which its own name names)."""

    what: str | None = None

    def __init__(self, device: torch.device, capture: bool, stream=None):
        self.device, self.capture, self.stream = device, capture, stream
        self.pieces: list[Piece] = []
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.held: dict[str, dict[str, int]] = {}   # graph -> {wrapper module: launches}
        self.capture_s = self.warmup_s = self.pool_bytes = None

    def _play(self, piece: Piece) -> None:
        if not self.capture:
            piece.run()
            return
        self.graphs[piece.name].replay()
        _lib.add_replayed(self.held[piece.name])

    def _first_run(self) -> dict[str, float]:
        """Warm up (every piece once, eagerly: the program's first run) and
        capture; returns each piece's warm-up seconds."""
        spent = self._warm_up()
        self._capture_all()
        return spent

    def _warm_up(self) -> dict[str, float]:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        spent = {}
        with torch.cuda.stream(side):
            for piece in self.pieces:
                t = time.perf_counter()
                piece.run()
                side.synchronize()
                spent[piece.name] = time.perf_counter() - t
        current.wait_stream(side)
        self.warmup_s = sum(spent.values())
        return spent

    def _capture(self, piece: Piece, pool, stream) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _lib.recorded()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                piece.run()
        except Exception as e:
            self.graphs.clear()
            what = piece.name if self.what is None else f"{self.what}'s {piece.name}"
            raise RuntimeError(f"CUDA graph capture of {what} failed at "
                               f"{_failure_site(e)}") from e
        self.graphs[piece.name] = graph
        after = _lib.recorded()
        self.held[piece.name] = {name: n - before.get(name, 0) for name, n in after.items()
                                 if n > before.get(name, 0)}

    def _capture_all(self) -> None:
        with _CAPTURING:
            self._capture_all_locked()

    def _capture_all_locked(self) -> None:
        t = time.perf_counter()
        # a garbage collection during a capture could destroy an unreachable
        # graph (of a dropped program) from this thread, a call the capture
        # refuses: collect now, and not while capturing
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            stream = self.stream if self.stream is not None else torch.cuda.Stream(self.device)
            for piece in self.pieces:
                self._capture(piece, pool, stream)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t


class _FunctionGraph(PieceGraphs):
    """One (dtype, shapes) of a `GraphedFunction`: its static inputs, its
    one piece and the outputs that piece leaves."""

    def __init__(self, fn, args, device, capture, stream, name: str):
        super().__init__(device, capture, stream)
        self.fn = fn
        self.inputs = [torch.empty(a.shape, dtype=a.dtype, device=device) for a in args]
        self.outputs = None
        self.pieces = [Piece(name, self._run)]

    def _run(self) -> None:
        self.outputs = self.fn(*self.inputs)

    def load(self, args, non_blocking: bool) -> None:
        for buf, a in zip(self.inputs, args):
            buf.copy_(a, non_blocking=non_blocking)


class GraphedFunction:
    """fn(*args) over tensors of fixed shapes, as CUDA graphs on `device`:
    one graph, with static input buffers, per (dtype, shapes) of the
    arguments (`entries`); a time is passed as a 0-d tensor, so none is
    baked into a graph. `run` copies its
    arguments into the buffers (`copy_`; tensors may lie on the host, pinned
    for `non_blocking`), replays the graph on the current stream (the first
    call of a shape warms fn up, captures it on `stream` into a pool of its
    own, then replays it) and returns fn's outputs in the graph's static
    tensors, which the caller copies out. `name` names it in a failed
    capture's error. With capture=False fn runs eagerly on the same buffers,
    on any device (the CPU tests)."""

    def __init__(self, fn, device: torch.device, name: str, *, capture: bool = True,
                 stream=None):
        if capture:
            require_cuda(device)
        self.fn, self.device, self.name, self.capture, self.stream = (fn, device, name, capture,
                                                                      stream)
        self.entries: dict[tuple, _FunctionGraph] = {}

    def run(self, *args, non_blocking: bool = False):
        """fn's outputs at args, in the graph's static tensors: the next run
        of the same shapes overwrites them."""
        key = tuple((a.dtype, tuple(a.shape)) for a in args)
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = _FunctionGraph(self.fn, args, self.device, self.capture,
                                                       self.stream, self.name)
        entry.load(args, non_blocking)
        if self.capture and not entry.graphs:
            entry._first_run()
        entry._play(entry.pieces[0])
        return entry.outputs
