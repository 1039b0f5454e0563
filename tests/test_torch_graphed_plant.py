"""PyTorch port, the dummy plant's graphed RK4 step (`sim/dummy.py::PlantStep`
over `utils/graphs.py::GraphedFunction`) on the CPU, at humanoid23's width,
both formulations, float64 and float32. Both models' flow maps are
time-invariant, so the step integrates each through a wrapper that adds
TIME_GAIN sin(t) to every state derivative: a time baked into a graph would
show. A CPU has no CUDA graphs, so the step runs through the graph runner
with capture off (`GraphedFunction(..., capture=False)` in place of its
graph), against

- the eager step (`graphs=False`), bit for bit, at several (t, x, u) in
  turn on the same runner; consecutive times move the result;
- the JAX package's `jax.jit(lambda t, x, u: rk4_step(flow, t, x, u, dt))`
  (`wb_humanoid_mpc_tpu/sim/dummy.py:49`) on the same numpy inputs: float64
  at 1e-10 max(1, max|ref|), float32 (JAX in pure float32) at 2e-3 max(1,
  max|ref|) (tests/test_torch_sqp.py's float32 tolerance);

and `run_dummy_sim` hands its `graphs` to the plant step it makes."""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    DTYPES,
    jax_centroidal,
    jax_mode,
    jax_wb,
    port_centroidal,
    port_wb,
)
from wb_humanoid_mpc_tpu.solver.transcription import rk4_step as jax_rk4_step
from wb_humanoid_mpc_tpu_torch.sim import dummy
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

TOL = {"f64": 1e-10, "f32": 2e-3}
TIME_GAIN = 0.05
DT = 0.02   # 50 Hz, the closed loops' plant rate
FORMULATIONS = {"wb": (port_wb, jax_wb), "centroidal": (port_centroidal, jax_centroidal)}
TIMES = (0.0, 0.3, 0.9)


def _timed(flow, sin):
    return lambda t, x, u: flow(t, x, u) + TIME_GAIN * sin(t)


@functools.lru_cache(maxsize=None)
def _setup(form: str, dtype: str):
    """(eager step, runner step, JAX's jitted step, calls [(t, x, u)])."""
    port_setup, jax_setup = FORMULATIONS[form]
    cfg, model, _ = port_setup("humanoid23")
    tdt = DTYPES[dtype][1]
    flow = _timed(model.flow_map, torch.sin)
    eager = dummy.PlantStep(flow, DT, torch.device("cpu"), tdt, graphs=False)
    runner = dummy.PlantStep(flow, DT, torch.device("cpu"), tdt, graphs=False)
    runner.graph = GraphedFunction(runner.step, runner.device, "RK4 step", capture=False)
    jflow = _timed(jax_setup("humanoid23")[1].flow_map, jnp.sin)
    with jax_mode(dtype):
        ref = jax.jit(lambda t, x, u: jax_rk4_step(jflow, t, x, u, DT))
    rng = np.random.default_rng(7)
    x0 = np.asarray(cfg.initial_state, dtype=np.float64)
    nu = model.layout.input_dim
    calls = [(t, x0 + 0.02 * rng.standard_normal(x0.size), 5.0 * rng.standard_normal(nu))
             for t in TIMES]
    return eager, runner, ref, calls


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_runner_equals_eager_bit_for_bit(form, dtype):
    eager, runner, _, calls = _setup(form, dtype)
    outs = []
    for t, x, u in calls:
        got, ref = runner(t, x, u), eager(t, x, u)
        assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref), (
            f"{form} {dtype} t={t}: max|runner - eager| {np.abs(got - ref).max():.3e}")
        outs.append(got)
    (entry,) = runner.graph.entries.values()
    assert not entry.graphs and entry.inputs[0].shape == ()
    # the same x and u at another time: the step reads t from its buffer
    t, x, u = calls[0]
    moved = np.abs(runner(t + 0.5, x, u) - outs[0]).max()
    assert moved > 1e-3 * TIME_GAIN * DT, moved


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_runner_matches_jax(form, dtype):
    _, runner, ref, calls = _setup(form, dtype)
    jdt = DTYPES[dtype][0]
    for t, x, u in calls:
        got = runner(t, x, u)
        with jax_mode(dtype):
            want = np.asarray(ref(t, jnp.asarray(x, jdt), jnp.asarray(u, jdt)), np.float64)
        limit = TOL[dtype] * max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= limit, f"{form} {dtype} t={t}: {err:.3e} > {limit:.3e}"


def test_run_dummy_sim_takes_the_switch(monkeypatch):
    """`run_dummy_sim` steps its plant through a `PlantStep` that gets its
    `graphs` (a stand-in runtime with a constant policy; each logged state
    is the previous one stepped)."""
    made = []

    class Spy(dummy.PlantStep):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(args[-1])

    class Runtime:
        device, dtype = torch.device("cpu"), torch.float64
        policy = types.SimpleNamespace(evaluate=lambda t: (np.zeros(3), np.ones(2), np.ones(2)))

        def advance(self, t, x, cmd):
            return None

    def flow(t, x, u):
        return -x + u.sum() + TIME_GAIN * torch.sin(t)

    x0 = np.array([1.0, 2.0, 3.0])
    step = dummy.PlantStep(flow, DT, torch.device("cpu"), torch.float64, graphs=False)
    monkeypatch.setattr(dummy, "PlantStep", Spy)
    for graphs in (False, None):
        log = dummy.run_dummy_sim(Runtime(), x0, 0.1, 1 / DT, 25.0, flow=flow, graphs=graphs)
        assert np.array_equal(log.states[1], step(0.0, x0, np.ones(2)))
        assert np.array_equal(log.states[2], step(DT, log.states[1], np.ones(2)))
    assert made == [False, None]
