"""PyTorch port, the async MPC/MRT runtime (`mpc/async_runtime.py`):

- the policy codec's round trip through a flat buffer;
- `SimulatedLatencyMpc` driving a replay plant (the state at t + dt read off
  the active policy, as the dummy sim with `flow=None`) for 0.4 s at 50 Hz
  with 25 Hz MPC and a 70 ms solve latency, in both packages on toy_biped
  (`build_wb_mpc`, N = 8, f64): the same dispatch ticks, overruns and active
  policy tick by tick (1e-8 max(1, max|ref|));
- an `MrtPipeline` on the CPU: observations in, at least three policies out
  through the seqlock buffers, a `PolicyObserver` that sees the same plane,
  a clean stop (tests/test_dummy_sim.py::test_mrt_pipeline_smoke);
- the failure path: a solve that raises, or returns a non-finite cost, sets
  `failed`, and `get_policy()` is None from then on.

Each threaded test waits at most DEADLINE seconds for the solver thread and
stops it in `finally`."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, LOOP_KW, NO_BATCHING_FALLBACK, build_pair
from wb_humanoid_mpc_tpu.mpc import async_runtime as jax_async
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.mpc import async_runtime
from wb_humanoid_mpc_tpu_torch.mpc.runtime import Policy

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

LOOP_TOL = 1e-8
DEADLINE = 120.0


def test_policy_codec_round_trip():
    rng = np.random.default_rng(0)
    N, nx, nu = 5, 7, 4
    pol = Policy(t0=0.37, dt=0.02, xs=rng.standard_normal((N + 1, nx)),
                 us=rng.standard_normal((N, nu)),
                 contact_flags=(rng.random((N + 1, 2)) > 0.5).astype(float))
    codec = async_runtime._PolicyCodec(N, nx, nu)
    buf = codec.pack(pol, 3.0)
    assert buf.shape == (codec.size,)
    seq, back = codec.unpack(buf)
    assert seq == 3.0 and back.t0 == pol.t0 and back.dt == pol.dt
    for name in ("xs", "us", "contact_flags"):
        np.testing.assert_array_equal(getattr(back, name), getattr(pol, name))
    assert codec.unpack(np.zeros(codec.size)) == (0.0, None)


def _latency_loop(mpc, sim_cls, duration=0.4, rate=50.0, mpc_rate=25.0, latency=0.07):
    """Per tick: (dispatched, active policy's t0, xs, us or None); overruns."""
    mpc.runtime.reset()
    sim = sim_cls(mpc.runtime, mpc_rate, latency)
    orig = mpc.runtime.advance
    calls = []

    def advance(*args, **kwargs):
        calls.append(args[0])
        return orig(*args, **kwargs)

    mpc.runtime.advance = advance
    try:
        x = np.asarray(mpc.initial_state, dtype=float)
        ticks = []
        dt = 1.0 / rate
        for k in range(int(round(duration * rate))):
            t = k * dt
            n_before = len(calls)
            pol = sim.tick(t, x, np.zeros(4))
            ticks.append((len(calls) > n_before,
                          None if pol is None else (pol.t0, np.asarray(pol.xs), np.asarray(pol.us))))
            if pol is not None:
                x = np.asarray(pol.evaluate(t + dt)[0], dtype=float)
    finally:
        del mpc.runtime.advance
    return ticks, sim.overruns, len(sim.stats)


def test_simulated_latency_matches_jax():
    jax_mpc, port_mpc = build_pair("wb")
    ref, ref_over, ref_n = _latency_loop(jax_mpc, jax_async.SimulatedLatencyMpc)
    got, got_over, got_n = _latency_loop(port_mpc, async_runtime.SimulatedLatencyMpc)
    assert (got_over, got_n) == (ref_over, ref_n)
    assert got_over > 0, "the latency should make dispatches late"
    assert [d for d, _ in got] == [d for d, _ in ref]
    for k, ((_, g), (_, r)) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None), f"tick {k}"
        if g is None:
            continue
        assert g[0] == r[0], f"tick {k}: active policy from t0 {g[0]} vs {r[0]}"
        for name, a, b in (("xs", g[1], r[1]), ("us", g[2], r[2])):
            b = np.asarray(b, np.float64)
            limit = LOOP_TOL * max(1.0, float(np.abs(b).max()))
            err = float(np.abs(a - b).max())
            assert err <= limit, f"tick {k} {name}: {err:.3e} > {limit:.3e}"
    assert sum(g is not None for _, g in got) >= 10


@pytest.fixture(scope="module")
def mpc():
    return interface.build_wb_mpc(*interface.mpc_files(ASSETS / "toy_biped", "wb"), **LOOP_KW,
                                  device="cpu", dtype=torch.float64)


def _drive(pipe, x, until, deadline=DEADLINE):
    """Push an observation every 20 ms until `until(pipe)` or the deadline."""
    end = time.monotonic() + deadline
    t_sim = 0.0
    while not until(pipe) and time.monotonic() < end:
        pipe.push_observation(t_sim, x, np.zeros(4))
        time.sleep(0.02)
        t_sim += 0.02


def test_mrt_pipeline_smoke(mpc):
    mpc.runtime.reset()
    pipe = async_runtime.MrtPipeline(mpc.runtime, nx=mpc.initial_state.shape[0], device="cpu")
    obs = async_runtime.PolicyObserver(pipe)
    assert pipe.get_policy() is None and obs.get_policy() is None and obs.evaluate(0.0) is None
    pipe.start()
    try:
        x = np.asarray(mpc.initial_state, dtype=float)
        _drive(pipe, x, lambda p: p.solve_count >= 3 or p.failed)
        assert pipe.solve_count >= 3, "the solver thread produced no policies"
        assert not pipe.failed
        pol = pipe.get_policy()
        assert pol is not None
        x_eval, u_eval, _ = pol.evaluate(pol.t0 + 0.01)
        assert np.isfinite(x_eval).all() and np.isfinite(u_eval).all()
        pol_obs = obs.get_policy()
        assert pol_obs is not None
        np.testing.assert_array_equal(pol_obs.xs, pol.xs)
        np.testing.assert_array_equal(obs.evaluate(pol.t0 + 0.01)[0], x_eval)
    finally:
        pipe.stop(timeout=DEADLINE)
    assert pipe._thread is None


@pytest.mark.parametrize("fault", ["raises", "nan_cost"])
def test_solver_failure_sets_failed(mpc, fault, monkeypatch):
    """The first solve publishes a policy; the second fails. From then on
    the control side gets no policy, and the thread has ended."""
    mpc.runtime.reset()
    orig = mpc.runtime.advance
    calls = []
    # the second solve waits until the first policy has been checked, so a
    # loaded machine cannot let it fail before the check
    first_checked = threading.Event()

    def advance(*args, **kwargs):
        calls.append(args[0])
        if len(calls) >= 2:
            first_checked.wait(DEADLINE)
        stats = orig(*args, **kwargs)
        if len(calls) < 2:
            return stats
        if fault == "raises":
            raise FloatingPointError("solve diverged")
        return dataclasses.replace(stats, cost=float("nan"))

    monkeypatch.setattr(mpc.runtime, "advance", advance)
    pipe = async_runtime.MrtPipeline(mpc.runtime, nx=mpc.initial_state.shape[0], device="cpu")
    pipe.start()
    try:
        x = np.asarray(mpc.initial_state, dtype=float)
        _drive(pipe, x, lambda p: p.solve_count >= 1)
        assert pipe.solve_count == 1 and pipe.get_policy() is not None
        first_checked.set()
        _drive(pipe, x, lambda p: p.failed)
        assert pipe.failed
        assert pipe.get_policy() is None
        assert pipe.solve_count == 1
        if fault == "raises":
            assert isinstance(pipe.error, FloatingPointError)
        pipe._thread.join(timeout=DEADLINE)
        assert not pipe._thread.is_alive()
    finally:
        first_checked.set()
        pipe.stop(timeout=DEADLINE)


def test_pipeline_refuses_a_runtime_on_another_device(mpc):
    with pytest.raises(ValueError, match="the runtime solves on cpu"):
        async_runtime.MrtPipeline(mpc.runtime, nx=4, device="meta")
