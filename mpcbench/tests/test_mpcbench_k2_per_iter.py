"""`metrics/k2_per_iter.py` on synthetic rings of the program's own trace:
K2's launches in the window's records over their SQP iterations, counted on
every record (the device's sample does not matter), and nothing read where
the ring does not match the window's solves one for one, the records carry
no launch counts (a program before the counter) or the program keeps no
records."""

from __future__ import annotations

import sys
import types

import pytest

from mpcbench import harness
from mpcbench.tests.small import benchmark
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.trace import Interval, Record, Span

MS = 1_000_000


def _record(k2: int, iterations: int = 2, recovery: bool = False, on_card: bool = True,
            counted: bool = True) -> Record:
    """advance [0, 40] ms, refs [0, 4] with the params at 3 ms, solve [5, 38]
    with A and C; `k2` K2 launches and one K1 launch an iteration."""
    spans = [Span("advance", None, 0, 40 * MS), Span("refs", 0, 0, 4 * MS),
             Span("params", 1, 3 * MS, 3 * MS + 50_000), Span("solve", 0, 5 * MS, 38 * MS),
             Span("A", 3, 6 * MS, 7 * MS), Span("C", 3, 20 * MS, 21 * MS)]
    device = [Interval("A", 6 * MS, 19 * MS), Interval("C", 21 * MS, 34 * MS)]
    rec = Record(seq=0, spans=spans, device=device if on_card else None,
                 replays={"A": iterations, "C": iterations}, since_ns=-MS,
                 iterations=iterations, recovery=recovery,
                 launches={"fkvel": k2, "riccati": iterations})
    if not counted:
        rec = types.SimpleNamespace(**{k: getattr(rec, k) for k in (
            "seq", "spans", "device", "replays", "since_ns", "iterations", "recovery",
            "advance")})
    return rec


def _solve(rec, late_s: float = 5e-4):
    return types.SimpleNamespace(iterations=rec.iterations, recovery=rec.recovery,
                                 wall_s=rec.advance.seconds + late_s)


@pytest.fixture(scope="module")
def metric():
    return harness.Cell(benchmark(), "wb-walk").metric("k2_per_iter")


def _read(metric, ring, solves, traced, monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: list(ring))
    run = types.SimpleNamespace(solves=solves, traced_solves=traced)
    return metric.read(run)


def test_it_is_a_per_layer_metric_of_the_whole_body_cell_only():
    b = benchmark()
    (entry,) = [m for m in harness.Cell(b, "wb-walk").per_layer() if m["name"] == "k2_per_iter"]
    assert entry["layer"] == "kernels" and entry["workloads"] == ["wb-walk"]
    assert entry["moves"] == "solves_per_s" and entry["source"] == "program_counter"
    assert "k2_per_iter" not in [m["name"] for m in harness.Cell(b, "cen-walk").per_layer()]


@pytest.mark.parametrize("traced", [0, 2])
def test_launches_over_the_window_iterations(metric, traced, monkeypatch):
    """13 + 13 + 78 + 13 launches over 2 + 2 + 12 + 2 iterations (one a
    recovery solve, one not timing the device); the ring's records before
    and after the window are not counted."""
    window = [_record(13), _record(13), _record(78, 12, True), _record(13, on_card=False)]
    ring = [_record(500)] * 3 + window + [_record(500)] * traced
    got = _read(metric, ring, [_solve(r) for r in window], traced, monkeypatch)
    assert got == pytest.approx(117 / 18)


def test_a_window_without_k2_reads_zero(metric, monkeypatch):
    window = [_record(0) for _ in range(3)]
    assert _read(metric, window, [_solve(r) for r in window], 0, monkeypatch) == 0.0


def test_a_ring_that_does_not_match_the_window_reads_nothing(metric, monkeypatch):
    rec = _record(13)
    for solves in ([types.SimpleNamespace(iterations=12, recovery=False,
                                          wall_s=rec.advance.seconds + 1e-4)],
                   [_solve(rec, late_s=-1e-6)], [_solve(rec)] * 2):
        assert _read(metric, [rec], solves, 0, monkeypatch) is None
    assert _read(metric, [rec], [_solve(rec)], 1, monkeypatch) is None


def test_records_without_launch_counts_read_nothing(metric, monkeypatch):
    """The parent's records, which count no launches, leave the metric out."""
    window = [_record(13, counted=False) for _ in range(2)]
    assert _read(metric, window, [_solve(r) for r in window], 0, monkeypatch) is None


def test_a_program_without_the_recorder_reads_nothing(metric, monkeypatch):
    import wb_humanoid_mpc_tpu_torch.utils as utils

    rec = _record(13)
    run = types.SimpleNamespace(solves=[_solve(rec)], traced_solves=0)
    monkeypatch.setattr(trace, "records", lambda: [rec])
    assert metric.read(run) == 6.5
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "wb_humanoid_mpc_tpu_torch.utils.trace", None)
    assert metric.read(run) is None
