"""JAX-free helpers of the compiled programs' CPU tests, importable by a rank
of `multihost.run_ranks` (which must import no JAX).

- `TimedPortOcp`: the port's whole-body OCP with every stage and terminal
  residual shifted by TIME_GAIN sin(t), so that a solve at another time than
  its call's t0 (a time baked into a CUDA graph) changes the answer;
- the emulated capture. A CPU has no CUDA graphs, so `PieceGraphs`' warm-up
  runs the pieces eagerly here (`warm_up`) and its capture runs each piece
  that a graph would hold under `Capturing`, a dispatch mode that gives
  every result a meaningless value (NaN, or 0 for integers and booleans),
  leaves every written tensor as it was and refuses host reads, as a
  capture does (`capture_all`; an eager piece, a collective between graphs,
  is not captured); a replay runs the piece eagerly (`Replay`). What a host
  reads after a program's first call must then have come through a static
  buffer from the warm-up or a replay;
- `run_cases_emulated`: `dryrun.run_cases` on a rank with the capture
  emulated and every program built there capturing so (the runners of
  `capture=False` included).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.utils.graphs import PieceGraphs

TIME_GAIN = 0.05


class TimedPortOcp(WholeBodyOcp):
    def fused_node(self, t, x, u, p):
        terms, xdot = super().fused_node(t, x, u, p)
        return terms._replace(r=terms.r + TIME_GAIN * torch.sin(t)[..., None]), xdot

    def terminal_residual(self, t, x, p):
        return super().terminal_residual(t, x, p) + TIME_GAIN * torch.sin(t)[..., None]


def _meaningless(t):
    if not isinstance(t, torch.Tensor):
        return t
    if t.is_floating_point():
        return torch.full_like(t, float("nan"))
    return torch.zeros_like(t)


class Capturing(TorchDispatchMode):
    """A capture's view of the operations it records: none runs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError(f"a capture refuses a host read ({func})")
        schema = func._schema
        if schema.is_mutable:
            # recorded, not run: the tensor it writes keeps its values
            if not schema.returns:
                return None
            if "out" in kwargs:
                return kwargs["out"]
            if schema.name.endswith("_"):
                return args[0]
            raise NotImplementedError(f"the emulated capture does not know {func}")
        return tree_map(_meaningless, func(*args, **kwargs))


class Replay:
    def __init__(self, run):
        self.replay = run


def warm_up(self):
    spent = {}
    for piece in self.pieces:
        piece.run()
        spent[piece.name] = 0.0
    self.warmup_s = 0.0
    return spent


def capture_all(self):
    for piece in self.pieces:
        if piece.eager:
            continue
        with Capturing():
            piece.run()
        self.graphs[piece.name] = Replay(piece.run)
        self.held[piece.name] = {}
    self.capture_s, self.pool_bytes = 0.0, 0


@contextlib.contextmanager
def emulated_capture():
    """Every `PieceGraphs` program built inside captures, as emulated,
    whatever its `capture`."""
    init = PieceGraphs.__init__

    def capturing_init(self, device, capture, stream=None):
        init(self, device, True, stream)

    with mock.patch.object(PieceGraphs, "_warm_up", warm_up), \
            mock.patch.object(PieceGraphs, "_capture_all", capture_all), \
            mock.patch.object(PieceGraphs, "__init__", capturing_init):
        yield


def run_cases_emulated(cases) -> list:
    """`dryrun.run_cases(cases)` with every program capturing as emulated."""
    with emulated_capture():
        return dryrun.run_cases(cases)
