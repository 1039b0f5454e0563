"""PyTorch port, the in-program trace (`utils/trace.py`) on the CPU: one
record per `MpcRuntime.advance` whose spans nest, `refs` and `solve` equal
to `SolveStats`' times to the bit, the idle split on synthetic spans and
device intervals, the ring's bound, the recorder switched off, graph B
counted on the lower ladder, no record from a thread with no open
`advance`, the profiler's `mpc.*` ranges and the publisher's summary.

The runtime is toy_biped's centroidal MPC at N = 4 in float64, its solve
the graphed runner with capture off (`GraphedSqpSolve(..., capture=False)`:
the graph sets' pieces run eagerly, so every replay span is there). The
device intervals exist on the card only; here a stand-in for
`torch.cuda.Event` (each event's time the host's clock when it was
recorded) checks how a record places them, and `tests/test_torch_cuda.py`
holds the placement on the card."""

from __future__ import annotations

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from tests._graphs_cases import _noise, solvers
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.interface import ASSETS
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpIteration, SqpSolverConfig
from wb_humanoid_mpc_tpu_torch.tools.benchmarks import BenchmarksPublisher
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.trace import Interval, Record, Span

CPU = torch.device("cpu")
RUNTIME_SPANS = {"advance", "refs", "params", "warm_start", "solve", "load", "A", "C",
                 "ladder_read", "stats_read", "readback", "policy"}


@pytest.fixture(scope="module")
def mpc():
    mpc = interface.build_centroidal_mpc(*interface.mpc_files(ASSETS / "toy_biped",
                                                              "centroidal"),
                                         n_nodes=4, device="cpu", dtype=torch.float64)
    cfg = SqpSolverConfig(n_nodes=mpc.n_nodes, dt=mpc.dt, sqp_iterations=2)
    it = SqpIteration(mpc.ocp, mpc.model.flow_map, mpc.ocp.barrier_params(CPU, torch.float64),
                      cfg)
    solve = GraphedSqpSolve(it, CPU, capture=False)
    mpc.runtime.solve_fn, mpc.runtime.recovery_solve_fn = solve, solve.with_iterations(12)
    return mpc


def _run(mpc, n: int) -> list:
    """n solves of a fresh episode, stance then a walk command."""
    rt = mpc.runtime
    rt.reset()
    x = np.asarray(mpc.initial_state, dtype=np.float64)
    out = []
    for k in range(n):
        out.append(rt.advance(0.02 * k, x, np.array([0.3, 0.0, 0.0, 0.0]) if k else np.zeros(4)))
        x = np.asarray(rt.policy.evaluate(0.02 * (k + 1))[0], dtype=np.float64)
    return out


def test_one_record_per_advance_with_nested_spans(mpc):
    before = trace.records()
    stats = _run(mpc, 3)
    new = trace.records()[len(before):] if len(before) < trace.CAPACITY else trace.records()[-3:]
    assert [s.trace for s in stats] == new and len(new) == 3
    assert [r.seq for r in new] == list(range(new[0].seq, new[0].seq + 3))
    for rec, st in zip(new, stats):
        names = [s.name for s in rec.spans]
        assert set(names) == RUNTIME_SPANS and names[0] == "advance"
        assert rec.spans[0].parent is None
        for k, s in enumerate(rec.spans[1:], 1):
            p = rec.spans[s.parent]
            assert s.parent < k and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
        by = {s.name: s for s in rec.spans}
        for name in ("refs", "warm_start", "solve", "readback", "policy"):
            assert rec.spans[by[name].parent].name == "advance"
        for name in ("load", "A", "C", "ladder_read", "stats_read"):
            assert rec.spans[by[name].parent].name == "solve"
        # the node params' graphed function, one replay inside refs
        assert rec.spans[by["params"].parent].name == "refs"
        # one replay span per piece and iteration, counted
        assert rec.iterations == st.iterations == 2 and rec.recovery is False
        assert rec.replays == {"A": 2, "C": 2, "params": 1} == {
            n: names.count(n) for n in ("A", "C", "params")}
        assert names.count("ladder_read") == 2
        # off the card there are no device intervals, hence no idle split
        assert rec.device is None and rec.idle_s == {} and rec.device_s == {}
        assert rec.self_s["advance"] >= 0 and abs(sum(rec.self_s.values())
                                                  - rec.advance.seconds) < 1e-9


def test_refs_and_solve_are_the_stats_times_to_the_bit(mpc):
    for st in _run(mpc, 2):
        by = {s.name: s for s in st.trace.spans}
        assert by["refs"].seconds == st.reference_time
        assert by["solve"].seconds == st.solve_time
        assert st.reference_time > 0 and st.solve_time > 0


def _synthetic() -> Record:
    """advance [100, 1000] with refs, solve (A inside it), policy; device
    busy [480, 700] (A) and [850, 950] (download); window from 0."""
    spans = [Span("advance", None, 100, 1000), Span("refs", 0, 100, 400),
             Span("solve", 0, 400, 900), Span("A", 2, 450, 500), Span("policy", 0, 900, 1000)]
    return Record(seq=0, spans=spans, device=[Interval("A", 480, 700),
                                               Interval("download", 850, 950)],
                  replays={"A": 1}, since_ns=0, iterations=1)


def test_idle_goes_to_the_innermost_span():
    rec = _synthetic()
    idle = {k: round(v * 1e9) for k, v in rec.idle_s.items()}
    # the gap [0, 480] crosses outside, refs, solve and A; [700, 850] lies in
    # solve; [950, 1000] in policy
    assert idle == {"outside": 100, "advance": 0, "refs": 300, "solve": 200, "A": 30,
                    "policy": 50}
    assert round(rec.idle_within("solve") * 1e9) == 230
    assert sum(idle.values()) == 480 + 150 + 50
    assert {k: round(v * 1e9) for k, v in rec.device_s.items()} == {"A": 220, "download": 100}
    assert {k: round(v * 1e9) for k, v in rec.self_s.items()} == {
        "advance": 0, "refs": 300, "solve": 450, "A": 50, "policy": 100}
    # device work overlapping, before the window and past advance's end
    rec = Record(seq=1, spans=[Span("advance", None, 100, 200)],
                 device=[Interval("x", 10, 120), Interval("y", 110, 130),
                         Interval("z", 190, 260)], replays={}, since_ns=50)
    assert {k: round(v * 1e9) for k, v in rec.idle_s.items()} == {"outside": 0, "advance": 60}


def test_ring_keeps_the_newest_records():
    first = trace.end(trace.begin(CPU), 0, False).seq
    for _ in range(trace.CAPACITY + 5):
        last = trace.end(trace.begin(CPU), 1, True)
    ring = trace.records()
    assert len(ring) == trace.CAPACITY
    assert ring[-1] is last and ring[0].seq == last.seq - trace.CAPACITY + 1 > first
    assert last.iterations == 1 and last.recovery is True
    assert [s.name for s in last.spans] == ["advance"]


def test_disabled_records_nothing_and_keeps_the_stats(mpc):
    on = _run(mpc, 3)
    trace.enable(False)
    try:
        n = trace.records()[-1].seq
        off = _run(mpc, 3)
        assert trace.records()[-1].seq == n
    finally:
        trace.enable(True)
    for a, b in zip(on, off):
        assert a.trace is not None and b.trace is None
        for field in ("cost", "g_norm", "defect_norm", "step_size", "iterations", "recovery"):
            assert getattr(a, field) == getattr(b, field), field
        assert b.reference_time > 0 and b.solve_time > 0


@pytest.fixture(scope="module")
def ladder():
    """The graphed runner (capture off) of tests/_graphs_cases.py's toy_biped
    stance at N = 6, and the x0 of its lower-ladder case."""
    pb, _, split = solvers(6, "f64", 1, {})
    noise = torch.as_tensor(_noise(pb.x0.shape[0]), dtype=pb.x0.dtype)
    return pb, split, pb.x0 + noise[2]


def test_lower_ladder_counts_graph_b(ladder):
    pb, split, x_low = ladder
    for x0, replays in ((x_low, {"A": 1, "B": 1, "C": 1}), (pb.x0, {"A": 1, "C": 1})):
        o = trace.begin(CPU)
        split(0.0, x0, pb.traj, pb.params, pb.lam)
        rec = trace.end(o, 1, False)
        assert rec.replays == replays
        assert [s.name for s in rec.spans] == ["advance", "load", *(
            ["A", "ladder_read", "B", "C"] if "B" in replays else ["A", "ladder_read", "C"])]


def test_no_record_from_a_thread_without_an_advance(ladder):
    pb, split, x_low = ladder
    n = trace.records()[-1].seq if trace.records() else -1
    split(0.0, x_low, pb.traj, pb.params, pb.lam)       # no record open anywhere
    assert (trace.records()[-1].seq if trace.records() else -1) == n
    o = trace.begin(CPU)                                # one open in this thread only
    worker = threading.Thread(target=split, args=(0.0, x_low, pb.traj, pb.params, pb.lam))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    rec = trace.end(o, 0, False)
    assert rec.replays == {} and [s.name for s in rec.spans] == ["advance"]
    assert trace.records()[-1] is rec and rec.seq > n


def test_spans_are_profiler_ranges_under_the_profiler():
    """Each span of an open record, a replay's included, is a
    `record_function("mpc.<name>")` range under the profiler, and none is
    opened outside it."""
    from torch.profiler import ProfilerActivity, profile

    def record():
        o = trace.begin(CPU)
        with trace.span("refs"):
            pass
        with trace.replay("A head"):
            torch.zeros(1)
        return trace.end(o, 1, False)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = record()
    assert {"mpc.advance", "mpc.refs", "mpc.A"} <= {e.key for e in prof.key_averages()}
    assert [s.name for s in rec.spans] == ["advance", "refs", "A"]
    assert [s.name for s in record().spans] == ["advance", "refs", "A"]


def test_publisher_summarises_the_records(mpc):
    pub = BenchmarksPublisher()
    for st in _run(mpc, 3):
        pub.publish(st)
    pub.publish(types.SimpleNamespace(solve_time=0.01, reference_time=0.002, cost=1.0,
                                      g_norm=0.0, step_size=1.0, trace=_synthetic()))
    out = pub.summary()
    json.dumps(out)
    assert len(pub.traces) == 4 and out["n_solves"] == 4
    assert set(out["span_self_time_p50"]) == RUNTIME_SPANS
    assert out["span_self_time_p50"]["refs"] > 0
    # the idle split of the one record that has device intervals
    assert out["idle_time_p50"] == pytest.approx(_synthetic().idle_s)
    plain = BenchmarksPublisher()
    plain.publish(types.SimpleNamespace(solve_time=0.01, reference_time=0.002, cost=1.0,
                                        g_norm=0.0, step_size=1.0))
    assert not {"span_self_time_p50", "idle_time_p50"} & set(plain.summary())


class _HostEvent:
    """`torch.cuda.Event` with the host's clock as the card's: an event's
    time is when it was recorded."""

    made = 0

    def __init__(self, enable_timing: bool = False):
        type(self).made += 1
        self.ns = None

    def record(self, stream=None) -> None:
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, end) -> float:
        return (end.ns - self.ns) * 1e-6


def test_events_are_placed_from_the_anchor(monkeypatch):
    """With each event's time the host's at its record, a record places
    every device pair by its distance to the anchor, placed at its own
    record: the pairs of each replay and group lie inside their spans; the
    idle time splits over the spans around them. The events are read when
    the intervals are first asked for, or during the thread's next
    record's first replay, and go back to the pool, which never grows past
    its reserve."""
    monkeypatch.setattr(trace.torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(trace._local, "pool", [], raising=False)
    monkeypatch.setattr(trace, "DEVICE_EVERY", 1)
    monkeypatch.setattr(_HostEvent, "made", 0)

    def record():
        o = trace.begin(torch.device("cuda"))
        with trace.span("refs"):
            trace.device_start("params_upload")
            time.sleep(1e-3)
            trace.device_end("params_upload")
        with trace.timed("solve"):
            trace.device_start("upload")
            with trace.span("load"):
                time.sleep(1e-3)
            trace.device_end("upload")
            for piece in ("A head", "C tail"):
                with trace.replay(piece):
                    time.sleep(2e-3)
            trace.device_start("download")
        with trace.span("readback"):
            time.sleep(1e-3)
            trace.device_end("download", anchor=True)
            time.sleep(1e-3)
        return trace.end(o, 1, False)

    rec = record()
    pool = trace._local.pool
    assert len(pool) == trace.EVENT_RESERVE - 10   # two events a pair, unread
    assert rec.replays == {"A": 1, "C": 1}
    assert [iv.name for iv in rec.device] == ["params_upload", "upload", "A", "C", "download"]
    assert len(pool) == trace.EVENT_RESERVE        # read, and back in the pool
    spans = {s.name: s for s in rec.spans}
    # placed no earlier than recorded, and later only by the anchor's record
    # call (here a few microseconds)
    for iv, first, last in zip(rec.device, ("refs", "solve", "A", "C", "solve"),
                               ("refs", "solve", "A", "C", "readback")):
        assert spans[first].start_ns <= iv.start_ns <= iv.end_ns <= spans[last].end_ns + 50_000
        assert iv.name == "download" or iv.end_ns - iv.start_ns >= 0.9e6
    # the anchor's host time is read just after its record
    assert 0.9e-3 <= (spans["readback"].end_ns - rec.device[-1].end_ns) * 1e-9 < 2e-3
    assert rec.device_s["A"] >= 2e-3 and rec.idle_s["A"] < 2e-3
    total = sum(rec.idle_s.values()) + sum(
        (iv.end_ns - iv.start_ns) * 1e-9 for iv in rec.device)
    assert total == pytest.approx((rec.advance.end_ns - rec.since_ns) * 1e-9, abs=2e-6)
    # a record left unread is read at the next record's first replay; the
    # pool, topped up at `begin`, then holds its events too, and needs no
    # more from then on
    first = record()
    o = trace.begin(torch.device("cuda"))
    assert len(pool) == trace.EVENT_RESERVE
    with trace.replay("A head"):
        pass
    assert len(pool) == trace.EVENT_RESERVE + 10 - 2
    trace.abandon(o)
    assert len(pool) == trace.EVENT_RESERVE + 10
    assert [iv.name for iv in first.device][-1] == "download"
    record().device
    assert _HostEvent.made == trace.EVENT_RESERVE + 10


def test_unread_events_go_back_to_the_pool_once(monkeypatch):
    """A record's device intervals asked for by many threads at once, while
    the thread that wrote it opens its next record and replays: every
    thread sees the same intervals, and each event goes back to the pool
    once (a lost read-then-clear would put it there twice)."""
    import sys

    monkeypatch.setattr(trace.torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(trace._local, "pool", [], raising=False)
    monkeypatch.setattr(trace, "DEVICE_EVERY", 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            o = trace.begin(torch.device("cuda"))
            for piece in ("A head", "C tail"):
                with trace.replay(piece):
                    pass
            trace.device_start("download")
            trace.device_end("download", anchor=True)
            rec = trace.end(o, 1, False)
            seen, go = [], threading.Barrier(9)

            def read():
                go.wait(timeout=30)
                seen.append(rec.device)

            readers = [threading.Thread(target=read) for _ in range(8)]
            for t in readers:
                t.start()
            go.wait(timeout=30)
            o = trace.begin(torch.device("cuda"))
            with trace.replay("A head"):
                pass
            trace.abandon(o)
            for t in readers:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in readers)
            assert len(seen) == 8 and all(d == seen[0] for d in seen)
            assert [iv.name for iv in seen[0]] == ["A", "C", "download"]
            pool = trace._local.pool
            assert len({id(e) for e in pool}) == len(pool)
    finally:
        sys.setswitchinterval(interval)


def test_one_record_in_device_every_times_the_device(monkeypatch):
    """On a CUDA device only the records whose sequence id is a multiple of
    `DEVICE_EVERY` carry device intervals; the others keep their spans and
    replay counts, record no event and leave the last timed record's
    events to be read at their first replay."""
    monkeypatch.setattr(trace.torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(trace._local, "pool", [], raising=False)
    monkeypatch.setattr(trace, "DEVICE_EVERY", 3)
    monkeypatch.setattr(_HostEvent, "made", 0)
    recs = []
    for _ in range(7):
        o = trace.begin(torch.device("cuda"))
        with trace.replay("A head"):
            pass
        trace.device_start("download")
        trace.device_end("download", anchor=True)
        recs.append(trace.end(o, 1, False))
    timed = [r.seq % 3 == 0 for r in recs]
    assert timed.count(True) in (2, 3)
    for r, t in zip(recs, timed):
        assert r.replays == {"A": 1} and [s.name for s in r.spans] == ["advance", "A"]
        assert (r.device is not None) == t
        if t:
            assert [iv.name for iv in r.device] == ["A", "download"]
    # the pool is filled once, at the first timed record, and keeps its
    # events: 4 a timed record, back after the next record's replay
    assert _HostEvent.made == trace.EVENT_RESERVE
    assert len(trace._local.pool) == trace.EVENT_RESERVE
