"""PyTorch port, the graphed MRT controllers (`mpc/controller.py` over
`utils/graphs.py::GraphedFunction`) on the CPU, at humanoid23's width (nx 58
whole-body, 35 centroidal), both formulations, float64 and float32. A CPU has
no CUDA graphs, so the controller's tick runs through the graph runner with
capture off (`GraphedFunction(..., capture=False)` in place of its graph: the
same host staging, static buffers and output copy as on the card), against

- the eager controller (`graphs=False`), bit for bit: the fallback before
  the first policy and a seeded policy at several times;
- the JAX package's controller, whose feed-forward is jitted
  (`jax.jit(model.joint_torques)`, the centroidal `ff_torques`), on the same
  numpy observations and policy: float64 at 1e-10 max(1, max|ref|), float32
  (JAX in pure float32, as on the TPU) at 2e-3 max(1, max|ref|)
  (tests/test_torch_sqp.py's float32 tolerance).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from tests.test_torch_common import (
    DTYPES,
    jax_centroidal,
    jax_mode,
    jax_wb,
    port_centroidal,
    port_wb,
)
from wb_humanoid_mpc_tpu.mpc import controller as jax_controller
from wb_humanoid_mpc_tpu.mpc.runtime import Policy as JaxPolicy
from wb_humanoid_mpc_tpu_torch.mpc import controller
from wb_humanoid_mpc_tpu_torch.mpc.runtime import Policy
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

TOL = {"f64": 1e-10, "f32": 2e-3}
FORMULATIONS = {
    "wb": (port_wb, jax_wb, controller.WBMrtController, jax_controller.WBMrtController),
    "centroidal": (port_centroidal, jax_centroidal, controller.CentroidalMrtController,
                   jax_controller.CentroidalMrtController),
}
TIMES = (0.0, 0.013, 0.05, 0.5)   # 0.5 s lies past the policy's 0.16 s


@functools.lru_cache(maxsize=None)
def _setup(form: str, dtype: str):
    """(eager controller, runner controller, JAX controller, x0, policy)."""
    port_setup, jax_setup, port_cls, jax_cls = FORMULATIONS[form]
    cfg, model, _ = port_setup("humanoid23")
    tdt = DTYPES[dtype][1]
    eager = port_cls(model, device="cpu", dtype=tdt, graphs=False)
    runner = port_cls(model, device="cpu", dtype=tdt, graphs=False)
    runner.graph = GraphedFunction(runner.feed_forward, runner.device, "feed-forward",
                                   capture=False)
    x0 = np.asarray(cfg.initial_state, dtype=np.float64)
    rng = np.random.default_rng(3)
    n = 5
    xs = x0 + 0.02 * rng.standard_normal((n, x0.size))
    us = np.tile(eager._u_comp, (n - 1, 1)) + 0.5 * rng.standard_normal((n - 1,
                                                                          eager._u_comp.size))
    pol = Policy(t0=0.0, dt=0.04, xs=xs, us=us, contact_flags=np.ones((n, 2)))
    with jax_mode(dtype):
        ref = jax_cls(jax_setup("humanoid23")[1])
    return eager, runner, ref, x0, pol


def _observations(x0, pol):
    rng = np.random.default_rng(4)
    return [(t, pol.evaluate(t)[0] + 0.01 * rng.standard_normal(x0.shape)) for t in TIMES]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_runner_equals_eager_bit_for_bit(form, dtype):
    eager, runner, _, x0, pol = _setup(form, dtype)
    for policy, t, x in [(None, 0.0, x0)] + [(pol, t, x) for t, x in _observations(x0, pol)]:
        got, ref = runner.compute(t, x, policy), eager.compute(t, x, policy)
        for name in ("q_des", "qd_des", "kp", "kd", "ff_effort"):
            a, b = getattr(got, name), getattr(ref, name)
            assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b), (
                f"{form} {dtype} t={t} policy={policy is not None} {name}: max|runner - eager| "
                f"{np.abs(a - b).max():.3e}")
    (entry,) = runner.graph.entries.values()
    assert not entry.graphs and entry.pieces[0].name == "feed-forward"


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_runner_matches_jax(form, dtype):
    _, runner, ref, x0, pol = _setup(form, dtype)
    jpol = JaxPolicy(t0=pol.t0, dt=pol.dt, xs=pol.xs.copy(), us=pol.us.copy(),
                     contact_flags=pol.contact_flags.copy())
    for policy, jp, t, x in ([(None, None, 0.0, x0)]
                             + [(pol, jpol, t, x) for t, x in _observations(x0, pol)]):
        got = runner.compute(t, x, policy)
        with jax_mode(dtype):
            want = ref.compute(t, x, jp)
        for name in ("q_des", "qd_des", "kp", "kd", "ff_effort"):
            a, b = getattr(got, name), np.asarray(getattr(want, name), dtype=np.float64)
            limit = TOL[dtype] * max(1.0, float(np.abs(b).max()))
            err = float(np.abs(a - b).max())
            assert err <= limit, f"{form} {dtype} t={t} {name}: {err:.3e} > {limit:.3e}"
        assert np.isfinite(got.ff_effort).all() and np.abs(got.ff_effort).max() > 0
