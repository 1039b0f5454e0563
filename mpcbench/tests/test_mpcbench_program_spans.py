"""The readers of the program's own trace (`metrics/idle_refs_ms.py`,
`idle_copies_ms.py`, `idle_solve_ms.py`, `graph_a_ms.py`,
`ladder_b_pct.py`, through `program_trace.py`) on synthetic rings: the
window sliced from the ring's end with and without a traced stretch after
it, each reader's arithmetic, and nothing read where the ring does not
match the window's solves one for one or the program keeps no records."""

from __future__ import annotations

import sys
import types

import pytest

from mpcbench import harness
from mpcbench.tests.small import benchmark
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.trace import Interval, Record, Span

MS = 1_000_000
READERS = ("idle_refs_ms", "idle_copies_ms", "idle_solve_ms", "graph_a_ms", "ladder_b_pct")


def _record(refs_ms: float = 10.0, iterations: int = 2, recovery: bool = False, b: int = 0,
            on_card: bool = True) -> Record:
    """advance [0, r + 38] ms, refs [0, r]; graph A busy 13 ms, C 13 ms, the
    readback's copy 0.5 ms; the window starts 2 ms before advance. Idle:
    refs r, warm_start 1, solve 8, readback 1.5, policy 1, outside 2."""
    r = refs_ms

    def ns(ms):
        return round(ms * MS)

    spans = [Span("advance", None, 0, ns(r + 38)), Span("refs", 0, 0, ns(r)),
             Span("warm_start", 0, ns(r), ns(r + 1)), Span("solve", 0, ns(r + 1), ns(r + 35)),
             Span("A", 3, ns(r + 2), ns(r + 3)), Span("C", 3, ns(r + 16), ns(r + 17)),
             Span("stats_read", 3, ns(r + 34), ns(r + 35)),
             Span("readback", 0, ns(r + 35), ns(r + 37)),
             Span("policy", 0, ns(r + 37), ns(r + 38))]
    device = [Interval("A", ns(r + 2), ns(r + 15)), Interval("C", ns(r + 17), ns(r + 30)),
              Interval("download", ns(r + 35.5), ns(r + 36))]
    replays = {"A": iterations, "C": iterations, **({"B": b} if b else {})}
    return Record(seq=0, spans=spans, device=device if on_card else None, replays=replays,
                  since_ns=-ns(2), iterations=iterations, recovery=recovery)


def _solve(rec: Record, late_s: float = 5e-4):
    return types.SimpleNamespace(iterations=rec.iterations, recovery=rec.recovery,
                                 wall_s=rec.advance.seconds + late_s)


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(benchmark(), "cen-walk")


def _read_all(cell, run, ring, monkeypatch) -> dict:
    monkeypatch.setattr(trace, "records", lambda: list(ring))
    return {name: cell.metric(name).read(run) for name in READERS}


def test_the_readers_are_the_cells_per_layer_metrics(cell):
    assert set(READERS) <= {m["name"] for m in cell.per_layer()}


@pytest.mark.parametrize("traced", [0, 3])
def test_window_is_sliced_from_the_ring_end(cell, traced, monkeypatch):
    window = [_record(10.0), _record(12.0, b=1), _record(14.0, iterations=12, recovery=True,
                                                         b=3)]
    ring = [_record(50.0), _record(60.0)] + window + [_record(90.0) for _ in range(traced)]
    run = types.SimpleNamespace(solves=[_solve(r) for r in window], traced_solves=traced)
    got = _read_all(cell, run, ring, monkeypatch)
    assert got["idle_refs_ms"] == pytest.approx(12.0)
    assert got["idle_copies_ms"] == pytest.approx(3.5)
    assert got["idle_solve_ms"] == pytest.approx(8.0)
    assert got["graph_a_ms"] == pytest.approx(13.0)
    assert got["ladder_b_pct"] == pytest.approx(100.0 * 4 / 16)


def test_the_device_readers_average_the_records_that_timed_it(cell, monkeypatch):
    """The recorder times the device on a sample of its records: the idle
    and replay readers average over those, the counter over every record."""
    window = [_record(10.0), _record(40.0, b=2, on_card=False), _record(14.0, b=1),
              _record(70.0, on_card=False)]
    run = types.SimpleNamespace(solves=[_solve(r) for r in window], traced_solves=0)
    got = _read_all(cell, run, window, monkeypatch)
    assert got["idle_refs_ms"] == pytest.approx(12.0)
    assert got["idle_copies_ms"] == pytest.approx(3.5)
    assert got["idle_solve_ms"] == pytest.approx(8.0)
    assert got["graph_a_ms"] == pytest.approx(13.0)
    assert got["ladder_b_pct"] == pytest.approx(100.0 * 3 / 8)


def _mismatches():
    rec = _record()
    return {
        "iterations": [types.SimpleNamespace(iterations=12, recovery=False,
                                             wall_s=rec.advance.seconds + 1e-4)],
        "recovery": [types.SimpleNamespace(iterations=2, recovery=True,
                                           wall_s=rec.advance.seconds + 1e-4)],
        "advance longer than the solve": [_solve(rec, late_s=-1e-6)],
        "advance 2 ms short of the solve": [_solve(rec, late_s=2.5e-3)],
        "more solves than records": [_solve(rec)] * 2,
    }


@pytest.mark.parametrize("case", list(_mismatches()))
def test_a_mismatch_reads_nothing(cell, case, monkeypatch):
    run = types.SimpleNamespace(solves=_mismatches()[case], traced_solves=0)
    assert set(_read_all(cell, run, [_record()], monkeypatch).values()) == {None}


def test_a_traced_stretch_longer_than_the_ring_reads_nothing(cell, monkeypatch):
    ring = [_record(), _record()]
    run = types.SimpleNamespace(solves=[_solve(r) for r in ring], traced_solves=1)
    assert set(_read_all(cell, run, ring, monkeypatch).values()) == {None}


def test_off_the_card_only_the_counter_reads(cell, monkeypatch):
    ring = [_record(b=1, on_card=False)]
    run = types.SimpleNamespace(solves=[_solve(ring[0])], traced_solves=0)
    got = _read_all(cell, run, ring, monkeypatch)
    assert got.pop("ladder_b_pct") == pytest.approx(50.0)
    assert set(got.values()) == {None}


def test_a_program_without_the_recorder_reads_nothing(cell, monkeypatch):
    """The parent commit's program has no `utils/trace.py`: each reader
    returns None and raises nothing, where a matching ring would read."""
    import wb_humanoid_mpc_tpu_torch.utils as utils

    ring = [_record()]
    run = types.SimpleNamespace(solves=[_solve(ring[0])], traced_solves=0)
    assert None not in _read_all(cell, run, ring, monkeypatch).values()
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "wb_humanoid_mpc_tpu_torch.utils.trace", None)
    assert {name: cell.metric(name).read(run) for name in READERS} == dict.fromkeys(READERS)
