"""`metrics/refs_graph_pct.py` on synthetic rings of the program's own
trace: the share of the window's records that hold a replay of the node
params' graph, counted on every record (the device's sample does not
matter), and nothing read where the ring does not match the window's
solves one for one or the program keeps no records."""

from __future__ import annotations

import sys
import types

import pytest

from mpcbench import harness
from mpcbench.tests.small import benchmark
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.trace import Interval, Record, Span

MS = 1_000_000


def _record(params: bool, iterations: int = 2, recovery: bool = False,
            on_card: bool = True) -> Record:
    """advance [0, 40] ms, refs [0, 4] (with a `params` replay at 3 ms when
    `params`), solve [5, 38] with A and C."""
    spans = [Span("advance", None, 0, 40 * MS), Span("refs", 0, 0, 4 * MS)]
    if params:
        spans.append(Span("params", 1, 3 * MS, 3 * MS + 50_000))
    spans += [Span("solve", 0, 5 * MS, 38 * MS), Span("A", len(spans), 6 * MS, 7 * MS),
              Span("C", len(spans), 20 * MS, 21 * MS)]
    device = [Interval("A", 6 * MS, 19 * MS), Interval("C", 21 * MS, 34 * MS)]
    replays = {"A": iterations, "C": iterations, **({"params": 1} if params else {})}
    return Record(seq=0, spans=spans, device=device if on_card else None, replays=replays,
                  since_ns=-MS, iterations=iterations, recovery=recovery)


def _solve(rec: Record, late_s: float = 5e-4):
    return types.SimpleNamespace(iterations=rec.iterations, recovery=rec.recovery,
                                 wall_s=rec.advance.seconds + late_s)


@pytest.fixture(scope="module")
def metric():
    return harness.Cell(benchmark(), "cen-walk").metric("refs_graph_pct")


def _read(metric, ring, solves, traced, monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: list(ring))
    run = types.SimpleNamespace(solves=solves, traced_solves=traced)
    return metric.read(run)


def test_it_is_a_per_layer_metric_of_the_cell():
    cell = harness.Cell(benchmark(), "cen-walk")
    (entry,) = [m for m in cell.per_layer() if m["name"] == "refs_graph_pct"]
    assert entry["layer"] == "MPC runtime: reference pipeline"
    assert entry["moves"] == "solves_per_s" and entry["source"] == "program_counter"


@pytest.mark.parametrize("traced", [0, 2])
def test_share_of_the_window_with_a_params_replay(metric, traced, monkeypatch):
    """3 of the window's 4 records replay the params (one a recovery solve,
    one not timing the device); the ring's records before and after the
    window, none of which replays them, are not counted."""
    window = [_record(True), _record(False), _record(True, 12, True),
              _record(True, on_card=False)]
    ring = [_record(False)] * 3 + window + [_record(False)] * traced
    got = _read(metric, ring, [_solve(r) for r in window], traced, monkeypatch)
    assert got == pytest.approx(75.0)


@pytest.mark.parametrize("params,want", [(True, 100.0), (False, 0.0)],
                         ids=["every-solve", "the-parent"])
def test_all_or_none(metric, params, want, monkeypatch):
    """Every record replaying the params reads 100; a program whose refs run
    eagerly (the parent's) reads 0, not nothing."""
    window = [_record(params) for _ in range(5)]
    assert _read(metric, window, [_solve(r) for r in window], 0, monkeypatch) == want


def test_a_ring_that_does_not_match_the_window_reads_nothing(metric, monkeypatch):
    rec = _record(True)
    for solves in ([types.SimpleNamespace(iterations=12, recovery=False,
                                          wall_s=rec.advance.seconds + 1e-4)],
                   [_solve(rec, late_s=-1e-6)], [_solve(rec)] * 2):
        assert _read(metric, [rec], solves, 0, monkeypatch) is None
    assert _read(metric, [rec], [_solve(rec)], 1, monkeypatch) is None


def test_a_program_without_the_recorder_reads_nothing(metric, monkeypatch):
    import wb_humanoid_mpc_tpu_torch.utils as utils

    rec = _record(True)
    run = types.SimpleNamespace(solves=[_solve(rec)], traced_solves=0)
    monkeypatch.setattr(trace, "records", lambda: [rec])
    assert metric.read(run) == 100.0
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "wb_humanoid_mpc_tpu_torch.utils.trace", None)
    assert metric.read(run) is None
