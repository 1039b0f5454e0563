"""The port's own trace of its MPC loop: host spans inside
`MpcRuntime.advance` and around every graph replay, the device intervals of
the same work on the host's clock, and the device's idle time split over
the host spans it fell in.

One call of `advance` is one `Record` (`begin` ... `end`); its spans share
the record's sequence id and nest:

    advance               the whole call
      refs                `MotionManager.pre_solve` and the node params
                          (its duration is `SolveStats.reference_time`)
        params            the replay of the centroidal node params' graph
      warm_start          the recovery decision, the shift or the
                          initializer, the uploads of the warm start
      solve               the solve call up to its four scalars
                          (its duration is `SolveStats.solve_time`)
        load              the inputs into the graph set's static buffers
        A, B, C, AC, G0   each replay of that piece (`replay`)
        ladder_read       the host waiting for graph A (`need_any`)
        stats_read        the four scalars to the host
      readback            xs, us to numpy
      policy              building the `Policy`

Device intervals come from CUDA event pairs (`torch.cuda.Event`) on the
stream the runtime runs on, taken from a pool of the thread's, in one
record of every `DEVICE_EVERY` (by sequence id; the others keep their
spans and counters, and `Record.device` None): one pair
around each replay, named by its piece, and one for each group of eager
copies: `params_upload` (the params' inputs, in `refs`), `upload` (from the
warm start's first upload to the end of `load`; to the solve's return for
a solve without static buffers, the eager twin) and `download` (from the
solution's clones, or `stats_read`, to the anchor in `readback`). A
group's pair counts as busy the host's time between its copies. Eager
kernels outside the pairs (the whole-body node params) are not timed
and count as idle: the device runs them between the host's launches. The
anchor is the end of `download`, recorded in `readback` between its two
synchronous copies: the first has drained the stream, so the card records
the event as the host does, and the second waits for it. It is placed at
the host's time of its record, and every other event of the record by its
distance to it, so clock drift cannot build up past one record. The
recorder adds no synchronisation: a record's events are read (and go back
to the pool) while the card runs the thread's next record's first replay,
when the host has time to spare, or when its intervals are first asked
for. A two-iteration solve records 14 events; on an H100's host they
cost about 0.2 ms of its critical path, which the sampling divides.

A record's idle time is the part of its window, from the end of the
thread's previous record to the end of this one, that no device interval
covers. Each idle stretch goes to the innermost span that holds it; what
lies before `advance` began goes to `outside` (the caller's time between
two calls).

Records are kept in a ring of the newest `CAPACITY` (`records()`), and
`SolveStats.trace` holds its solve's. Only a thread with an open record
records: the MRT controllers' replays in their own thread are not
recorded, nor is a program's first run (its warm-up and capture), which
replays nothing. Under `torch.profiler` each span also opens
`record_function("mpc.<name>")`, so the profiler's trace carries the
spans beside the kernels, replays included.

On by default; `enable(False)` turns it off for the process, which leaves
one flag check per span and replay.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 8192
# CUDA events a thread's pool holds at the start of each record that times
# the device, enough for a 12-iteration recovery solve (4-5 pairs an
# iteration), so that creating them never lands inside a span
EVENT_RESERVE = 128
# device events on one record in this many: the records between keep the
# recorder's cost a small share of a solve, and the device's means come
# from an eighth of the solves
DEVICE_EVERY = 8
OUTSIDE = "outside"

_enabled = True
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_seq = itertools.count()
# .open: the thread's open record; .last_end_ns; .pool; .unread: its last
# record, while its events are unread
_local = threading.local()
_READING = threading.Lock()


def enable(on: bool = True) -> None:
    """Turn the recorder on or off for the whole process."""
    global _enabled
    _enabled = bool(on)


def records() -> list[Record]:
    """The ring's records, oldest first."""
    return list(_ring)


class Span(NamedTuple):
    name: str
    parent: int | None   # index in `Record.spans` of the enclosing span; None for `advance`
    start_ns: int        # time.perf_counter_ns()
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Interval(NamedTuple):
    """Device work on the host's clock: a replay (named by its piece) or a
    group of eager copies."""
    name: str
    start_ns: int
    end_ns: int


class Record:
    """One `advance`: its spans (`spans[0]` is `advance`, each other span
    after its parent), its device intervals (None off a CUDA device and on
    the records that do not time it: `DEVICE_EVERY`), its replays by
    piece, the solve's SQP iterations and whether it ran the recovery
    solve. Its window starts at `since_ns`.

    The recorder hands it raw rows: the spans as (name, parent, start_ns,
    end_ns), and its device pairs unread (`_Unread`), which become their
    names, the anchor's host time and each event's milliseconds before it
    once read. It keeps them in tuples, which Python's garbage collector
    stops tracking, so that a full ring does not lengthen every collection
    of the process; `Span`s, `Interval`s and the sums below are built when
    first read, off the solve's path."""

    __slots__ = ("seq", "replays", "since_ns", "iterations", "recovery", "_spans", "_device",
                 "_memo")

    def __init__(self, seq: int, spans, device, replays: dict[str, int], since_ns: int,
                 iterations: int = 0, recovery: bool = False):
        self.seq, self.replays, self.since_ns = seq, replays, since_ns
        self.iterations, self.recovery = iterations, recovery
        self._spans = tuple(tuple(s) for s in spans)
        self._device = tuple(device) if isinstance(device, list) else device
        self._memo = None

    def _cached(self, key: str, make):
        if self._memo is None:
            self._memo = {}
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    @property
    def spans(self) -> list[Span]:
        return self._cached("spans", lambda: [Span._make(s) for s in self._spans])

    @property
    def device(self) -> list[Interval] | None:
        return self._cached("device", self._intervals)

    def _intervals(self) -> list[Interval] | None:
        d = self._device
        if isinstance(d, _Unread):
            d = self._device = d.read()
        if d is None or not d or isinstance(d[0], Interval):
            return None if d is None else list(d)
        names, at, ms = d
        return [Interval(name, at - round(ms[2 * j] * 1e6), at - round(ms[2 * j + 1] * 1e6))
                for j, name in enumerate(names)]

    @property
    def advance(self) -> Span:
        return self.spans[0]

    @property
    def self_s(self) -> dict[str, float]:
        """Seconds by span name, less what the child spans cover."""
        return self._cached("self_s", self._self_s)

    def _self_s(self) -> dict[str, float]:
        ns: dict[str, int] = {}
        for s in self.spans:
            ns[s.name] = ns.get(s.name, 0) + s.end_ns - s.start_ns
            if s.parent is not None:
                parent = self.spans[s.parent].name
                ns[parent] = ns.get(parent, 0) - (s.end_ns - s.start_ns)
        return {k: v * 1e-9 for k, v in ns.items()}

    @property
    def device_s(self) -> dict[str, float]:
        """Device seconds by interval name (a piece or a group of copies)."""
        return self._cached("device_s", self._device_s)

    def _device_s(self) -> dict[str, float]:
        ns: dict[str, int] = {}
        for iv in self.device or ():
            ns[iv.name] = ns.get(iv.name, 0) + iv.end_ns - iv.start_ns
        return {k: v * 1e-9 for k, v in ns.items()}

    def _idle(self) -> list[tuple[int, int]]:
        """The stretches of the window that no device interval covers."""
        hi = self.advance.end_ns
        out, at = [], self.since_ns
        for a, b in sorted((iv.start_ns, iv.end_ns) for iv in self.device):
            if a > at:
                out.append((at, min(a, hi)))
            at = max(at, b)
            if at >= hi:
                break
        if at < hi:
            out.append((at, hi))
        return out

    def _idle_ns(self, start: int, end: int) -> int:
        return sum(max(0, min(b, end) - max(a, start))
                   for a, b in self._cached("idle", self._idle))

    @property
    def idle_s(self) -> dict[str, float]:
        """Device idle seconds by the innermost span that holds them, and
        `outside` (before `advance`); empty off a CUDA device."""
        return self._cached("idle_s", self._idle_s)

    def _idle_s(self) -> dict[str, float]:
        if self.device is None:
            return {}
        ns = {OUTSIDE: self._idle_ns(self.since_ns, self.advance.start_ns)}
        for s in self.spans:
            within = self._idle_ns(s.start_ns, s.end_ns)
            ns[s.name] = ns.get(s.name, 0) + within
            if s.parent is not None:
                parent = self.spans[s.parent].name
                ns[parent] = ns.get(parent, 0) - within
        return {k: v * 1e-9 for k, v in ns.items()}

    def idle_within(self, name: str) -> float:
        """Device idle seconds inside the spans named `name`, their child
        spans' included (0 off a CUDA device)."""
        if self.device is None:
            return 0.0
        return sum(self._idle_ns(s.start_ns, s.end_ns) for s in self.spans
                   if s.name == name) * 1e-9


class _Unread:
    """A record's device pairs up to its anchor, read once (any thread),
    their events then back in the pool of the thread that recorded them."""

    __slots__ = ("pairs", "at_ns", "pool", "raw")

    def __init__(self, pairs: list, at_ns: int, pool: list):
        self.pairs, self.at_ns, self.pool, self.raw = pairs, at_ns, pool, None

    def read(self) -> tuple:
        """(names, the anchor's host time, each event's milliseconds before
        the anchor); every event has completed, since the caller waited
        after the anchor."""
        with _READING:
            if self.raw is None:
                anchor = self.pairs[-1][2]
                ms = []
                for _, a, b in self.pairs:
                    ms += (a.elapsed_time(anchor), b.elapsed_time(anchor))
                self.raw = tuple(name for name, _, _ in self.pairs), self.at_ns, tuple(ms)
                for _, a, b in self.pairs:
                    self.pool += (a, b)
                self.pairs = ()
            return self.raw


def _profiling() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


class _Open:
    """The record one thread is writing; on a CUDA device its events go on
    the stream that was current when it opened, the runtime's."""

    __slots__ = ("seq", "stream", "profiling", "since_ns", "spans", "stack", "replays",
                 "started", "pairs", "anchor", "pool", "unread", "range")

    def __init__(self, seq: int, stream, since_ns: int, pool: list, unread: _Unread | None):
        self.seq = seq
        self.stream, self.since_ns, self.pool, self.unread = stream, since_ns, pool, unread
        self.profiling = _profiling()
        self.spans: list[list] = []     # [name, parent, start_ns, end_ns]
        self.stack: list[int] = []      # the open spans, innermost last
        self.replays: dict[str, int] = {}
        self.started: dict[str, torch.cuda.Event] = {}   # open pairs: name -> start event
        self.pairs: list[tuple] = []    # (name, start event, end event)
        self.anchor: tuple[int, int] | None = None   # (pairs up to it, its host time)
        self.range = None   # the profiler's range of `advance`

    def refill(self) -> None:
        """Top the pool up to `EVENT_RESERVE` events, each recorded once so
        that its CUDA event exists before a span records it."""
        while len(self.pool) < EVENT_RESERVE:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
            self.pool.append(event)

    def mark(self) -> torch.cuda.Event:
        """An event of the pool, recorded on the stream."""
        event = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        return event

    def start(self, name: str) -> None:
        if name not in self.started:
            self.started[name] = self.mark()

    def end(self, name: str, anchor: bool = False) -> None:
        start = self.started.pop(name, None)
        if start is not None:
            self.pairs.append((name, start, self.mark()))
            if anchor:
                self.anchor = (len(self.pairs), time.perf_counter_ns())

    def read_unread(self) -> None:
        """Read the thread's previous record's events, if still unread."""
        if self.unread is not None:
            unread, self.unread = self.unread, None
            unread.read()

    def release(self) -> None:
        for event in self.started.values():
            self.pool.append(event)
        for _, a, b in self.pairs:
            self.pool += (a, b)
        self.started, self.pairs = {}, []
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None

    def finish(self, iterations: int, recovery: bool) -> Record:
        """The record, its device pairs up to the anchor kept unread."""
        device = None
        if self.anchor is not None:
            k, at = self.anchor
            device = _Unread(self.pairs[:k], at, self.pool)
            self.pairs = self.pairs[k:]
        self.release()
        return Record(self.seq, self.spans, device, self.replays, self.since_ns,
                      int(iterations), bool(recovery))


class _Span:
    """A host span of the open record (with `paired`, also a device pair
    of its name just inside it: a replay); with no open record it only
    reads the clock."""

    __slots__ = ("_open", "name", "paired", "start_ns", "end_ns", "_index", "_start", "_range")

    def __init__(self, open_: _Open | None, name: str, paired: bool = False):
        self._open, self.name, self.paired = open_, name, paired
        self._range = None

    def __enter__(self) -> _Span:
        o = self._open
        if o is None:
            self.start_ns = time.perf_counter_ns()
            return self
        if o.profiling:
            self._range = torch.autograd.profiler.record_function("mpc." + self.name)
            self._range.__enter__()
        self.start_ns = t = time.perf_counter_ns()
        stack, spans = o.stack, o.spans
        self._index = len(spans)
        spans.append([self.name, stack[-1], t, 0])
        stack.append(self._index)
        if self.paired and o.stream is not None:
            self._start = o.mark()
        return self

    def __exit__(self, *exc) -> None:
        o = self._open
        if o is None:
            self.end_ns = time.perf_counter_ns()
            return
        if self.paired and o.stream is not None:
            o.pairs.append((self.name, self._start, o.mark()))
        self.end_ns = t = time.perf_counter_ns()
        o.spans[self._index][3] = t
        o.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.paired and o.unread is not None:
            # the card runs the replay just queued: read the last record's
            # events while the host would only wait
            o.read_unread()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _Null()


def _current() -> _Open | None:
    return getattr(_local, "open", None) if _enabled else None


def _on_card() -> _Open | None:
    o = _current()
    return None if o is None or o.stream is None else o


def begin(device) -> _Open | None:
    """Open this thread's record of one `advance` (its `advance` span
    starts now; on a CUDA device, with device events in one record of
    every `DEVICE_EVERY`); None when the recorder is off."""
    if not _enabled:
        return None
    if getattr(_local, "open", None) is not None:
        raise RuntimeError("a trace record is already open in this thread")
    now = time.perf_counter_ns()
    pool = _local.__dict__.setdefault("pool", [])
    since = getattr(_local, "last_end_ns", None)
    seq = next(_seq)
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device)
              if device.type == "cuda" and seq % DEVICE_EVERY == 0 else None)
    o = _Open(seq, stream, now if since is None else since, pool,
              _local.__dict__.pop("unread", None))
    if stream is not None:
        o.refill()
    if o.profiling:
        o.range = torch.autograd.profiler.record_function("mpc.advance")
        o.range.__enter__()
    o.spans.append(["advance", None, now, 0])
    o.stack.append(0)
    _local.open = o
    return o


def end(o: _Open | None, iterations: int, recovery: bool) -> Record | None:
    """Close the record `begin` opened, keep it in the ring and return it
    (its device intervals are read later: the caller waits after the
    anchor); None for None."""
    if o is None:
        return None
    now = time.perf_counter_ns()
    o.spans[0][3] = now
    _local.open = None
    _local.last_end_ns = now
    record = o.finish(iterations, recovery)
    o.read_unread()   # a record with no replay reads the last one here
    if isinstance(record._device, _Unread):
        _local.unread = record._device
    _ring.append(record)
    return record


def abandon(o: _Open | None) -> None:
    """Drop the record `begin` opened (its call raised)."""
    if o is not None:
        _local.open = None
        o.read_unread()
        o.release()


def span(name: str):
    """A host span of the open record; a no-op with none open."""
    o = _current()
    return _NULL if o is None else _Span(o, name)


def timed(name: str) -> _Span:
    """A span that always reads the clock (its `seconds`), recorded when a
    record is open: the spans whose durations `SolveStats` reports."""
    return _Span(_current(), name)


def replay(piece: str):
    """The span and device pair of one replay of `piece` (named by its
    first word), counted; a no-op with no record open."""
    o = _current()
    if o is None:
        return _NULL
    name = piece.partition(" ")[0]
    o.replays[name] = o.replays.get(name, 0) + 1
    return _Span(o, name, paired=True)


def device_start(name: str) -> None:
    """Start the device pair `name` of the open record (a group of eager
    device work, which may end in another span: `device_end`), unless it
    is started already; a no-op off a CUDA device."""
    o = _on_card()
    if o is not None:
        o.start(name)


def device_end(name: str, anchor: bool = False) -> None:
    """End the device pair `name` if it is started. `anchor`: its end event
    is the record's anchor, placed on the host's clock at its record: the
    caller ends the pair where the stream has just drained (after a
    synchronous copy) and then waits for it (another synchronous copy).
    Nothing recorded after the anchor is read."""
    o = _on_card()
    if o is not None:
        o.end(name, anchor)
