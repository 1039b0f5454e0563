"""Per-solve benchmark aggregation + publishing (host numpy).

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/tools/benchmarks.py`.

Replaces `SqpBenchmarksPublisher`/`DdpBenchmarksPublisher`
(reference `SqpBenchmarksPublisher.cpp:36-60`: streams {LQ approximation, QP
solve, linesearch, controller} wall times per solve) and the runtime
`FPSTracker` (reference `robot_core/FPSTracker.h:40-59`). The in-process
equivalent of the `/humanoid/mpc_benchmarks` topic is a subscriber-callback
registry on `BenchmarksPublisher`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


class FPSTracker:
    """EWMA frame-rate tracker (reference `FPSTracker.h:40-59`)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps = 0.0
        self._last: float | None = None

    def tick(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = 1.0 / dt
            self.fps = inst if self.fps == 0.0 else (
                self.alpha * inst + (1 - self.alpha) * self.fps)
        self._last = now
        return self.fps


@dataclasses.dataclass
class SolveBenchmark:
    solve_time: float
    reference_time: float
    cost: float
    g_norm: float
    step_size: float
    # per-phase device wall times (reference SqpSolver::Benchmarks fields,
    # `SqpBenchmarksPublisher.cpp:44-57`); populated when the runtime solves
    # through `make_staged_sqp_solver`, zero for the fused production solver
    lq_time: float = 0.0
    projection_time: float = 0.0
    riccati_time: float = 0.0
    linesearch_time: float = 0.0


class BenchmarksPublisher:
    """Collects per-solve stats; notifies registered subscribers (the topic
    analogue) and produces summary percentiles."""

    def __init__(self):
        self.history: list[SolveBenchmark] = []
        self._subscribers = []

    def subscribe(self, fn) -> None:
        self._subscribers.append(fn)

    def publish(self, stats) -> None:
        b = SolveBenchmark(
            solve_time=stats.solve_time,
            reference_time=stats.reference_time,
            cost=stats.cost,
            g_norm=stats.g_norm,
            step_size=stats.step_size,
            lq_time=getattr(stats, "lq_time", 0.0),
            projection_time=getattr(stats, "projection_time", 0.0),
            riccati_time=getattr(stats, "riccati_time", 0.0),
            linesearch_time=getattr(stats, "linesearch_time", 0.0),
        )
        self.history.append(b)
        for fn in self._subscribers:
            fn(b)

    def summary(self) -> dict:
        if not self.history:
            return {}
        st = np.array([b.solve_time for b in self.history])
        out = {
            "n_solves": len(self.history),
            "solve_time_p50": float(np.percentile(st, 50)),
            "solve_time_p95": float(np.percentile(st, 95)),
            "solve_time_max": float(st.max()),
            "solve_rate_hz": float(1.0 / max(np.percentile(st, 50), 1e-9)),
            "g_norm_max": float(max(b.g_norm for b in self.history)),
            "mean_step_size": float(np.mean([b.step_size for b in self.history])),
        }
        for phase in ("lq", "projection", "riccati", "linesearch"):
            vals = np.array([getattr(b, f"{phase}_time") for b in self.history])
            if vals.any():
                out[f"{phase}_time_p50"] = float(np.percentile(vals, 50))
        return out
