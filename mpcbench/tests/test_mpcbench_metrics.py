"""The metric arithmetic on synthetic inputs: the tail over all requests,
the rate over the whole window, the per-layer means and shares, the
rooflines from shapes, and the reduction of a profiler trace."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from mpcbench import harness, roofline
from mpcbench.tests.small import benchmark

CONFIG = {"dtype": "float32", "n_nodes": 28, "nx": 58, "nu": 35, "n_eq": 14, "n_joints": 23}


def _solve(wall, iterations=2, recovery=False, solve=None, refs=0.002):
    return types.SimpleNamespace(wall_s=wall, iterations=iterations, recovery=recovery,
                                 solve_s=wall - refs if solve is None else solve, refs_s=refs)


def _run(solves, window_s=10.0, trace=None, replay_busy_s=None):
    return types.SimpleNamespace(solves=solves, window_s=window_s, setup_s=12.5, config=CONFIG,
                                 trace=trace, replay_busy_s=replay_busy_s)


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(benchmark(later=True), "wb-walk")


def _read(cell, name, run):
    return cell.metric(name).read(run)


def test_p95_is_over_every_request(cell):
    walls = [0.001 * (i + 1) for i in range(100)]   # 1 .. 100 ms
    run = _run([_solve(w) for w in walls])
    assert _read(cell, "solve_ms_p95", run) == pytest.approx(95.05)
    # not a median of chunks: chunk p95s of 10 would read at most 95.5
    run = _run([_solve(0.01)] * 94 + [_solve(0.5)] * 6)
    assert _read(cell, "solve_ms_p95", run) == pytest.approx(500.0)


def test_rate_is_over_the_whole_window(cell):
    run = _run([_solve(0.05)] * 123, window_s=12.3)
    assert _read(cell, "solves_per_s", run) == pytest.approx(10.0)
    assert _read(cell, "setup_s", run) == 12.5
    assert _read(cell, "solves_per_s", _run([])) is None


def test_layer_means_and_shares(cell):
    solves = [_solve(0.05, 2, False, solve=0.04, refs=0.003),
              _solve(0.25, 12, True, solve=0.24, refs=0.005)]
    run = _run(solves)
    assert _read(cell, "refs_ms", run) == pytest.approx(4.0)
    assert _read(cell, "recovery_pct", run) == pytest.approx(50.0)
    assert _read(cell, "sqp_iter_ms", run) == pytest.approx(1e3 * 0.28 / 14)


def test_roofline_counts_from_shapes():
    nbytes, ops = roofline.riccati_work(1, 28, 58, 21, 4)
    assert ops == pytest.approx(38.0e6, rel=0.01)
    assert nbytes == pytest.approx(1.25e6, rel=0.01)
    assert roofline.bound_s(nbytes, ops, 4) == pytest.approx(ops / 67e12)
    nbytes, ops = roofline.fkvel_work(28, 23, 4)
    assert nbytes == pytest.approx(79.7e3, rel=0.01)
    assert roofline.bound_s(nbytes, ops, 4) == pytest.approx(nbytes / 3.35e12)


def _chrome_trace(tmp_path, ops):
    """A trace of the annotation [0, 1000] us and device ops (name, ts,
    dur, grid, launch)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "win", "ts": 0.0, "dur": 1000.0}]
    for k, (name, ts, dur, grid, launch) in enumerate(ops):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                       "args": {"grid": grid, "correlation": k}})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": launch, "ts": ts - 5,
                       "dur": 2, "args": {"correlation": k}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return harness.DeviceTrace(path, "win")


def test_device_trace_reduction(tmp_path):
    t = _chrome_trace(tmp_path, [
        ("a", 100.0, 100.0, [1, 1, 1], "cudaGraphLaunch"),
        ("b", 150.0, 100.0, [1, 1, 1], "cudaGraphLaunch"),   # overlaps a
        ("riccati_rollout_kernel<float>", 600.0, 200.0, [1, 1, 1], "cudaLaunchKernel"),
        ("outside", 1200.0, 10.0, [1, 1, 1], "cudaLaunchKernel"),
    ])
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert [round(d, 9) for d, _ in t.kernels("riccati_rollout_kernel")] == [200e-6]
    b = t.breakdown()
    assert b["device_ops"][0] == ["riccati_rollout_kernel<float>", pytest.approx(200e-6)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["host cudaLaunchKernel then riccati_rollout_kernel<float>"] == pytest.approx(350e-6)
    assert gaps["end of window"] == pytest.approx(200e-6)


def test_rooflines_and_idle_from_a_trace(tmp_path, cell):
    k1_bytes, k1_ops = roofline.riccati_work(1, 28, 58, 21, 4)
    k1_bound = roofline.bound_s(k1_bytes, k1_ops, 4)
    k2_bound = roofline.bound_s(*roofline.fkvel_work(56, 23, 4), 4)
    t = _chrome_trace(tmp_path, [
        ("void riccati_rollout_kernel<float>", 10.0, 500.0, [1, 1, 1], "cudaGraphLaunch"),
        ("void fkvel_kernel<float>", 600.0, 5.0, [56, 1, 1], "cudaGraphLaunch"),
        ("void fkvel_kernel<float>", 700.0, 5.0, [56, 1, 1], "cudaGraphLaunch"),
    ])
    run = _run([_solve(0.05)], window_s=2.0, trace=t, replay_busy_s=1.5)
    assert _read(cell, "k1_roofline_pct", run) == pytest.approx(100 * k1_bound / 500e-6)
    assert _read(cell, "k2_roofline_pct", run) == pytest.approx(100 * k2_bound / 5e-6)
    assert _read(cell, "device_idle_pct", run) == pytest.approx(25.0)
    # nothing to read: the metric is left out, never 0
    empty = _run([_solve(0.05)], trace=_chrome_trace(tmp_path, []))
    assert _read(cell, "k1_roofline_pct", empty) is None
    assert _read(cell, "device_idle_pct", empty) is None
    out = harness.read_metrics(cell, cell.per_layer(), empty)
    assert "k1_roofline_pct" not in out and "recovery_pct" in out


def test_percentile_helper():
    v = np.arange(1, 101, dtype=float)
    assert harness.percentile(v, 50) == pytest.approx(50.5)
