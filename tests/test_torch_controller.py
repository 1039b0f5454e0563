"""PyTorch port, the MRT joint controllers (`mpc/controller.py`) against the
JAX package's on toy_biped in float64 on the CPU: `robot_state_to_generalized`
for seeded random base orientations and velocities (1e-12), and
`CentroidalMrtController.compute` / `WBMrtController.compute` before the
first policy (the weight-compensating fallback) and with a policy carried
across from one solve of the port's `build_*_mpc` (N = 8), at seeded
observations around it (1e-9 max(1, max|ref|)). Both packages get the same
numpy policy and observations."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    ASSETS,
    LOOP_KW,
    NO_BATCHING_FALLBACK,
    jax_centroidal,
    jax_wb,
)
from wb_humanoid_mpc_tpu.mpc import controller as jax_controller
from wb_humanoid_mpc_tpu.mpc.runtime import Policy as JaxPolicy
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.mpc import controller

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

CTRL_TOL = 1e-9


def _quat(rng):
    q = rng.standard_normal(4)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("seed", range(4))
def test_robot_state_to_generalized(seed):
    rng = np.random.default_rng(seed)
    n_j = 12
    args = [rng.standard_normal(3), _quat(rng), rng.standard_normal(3), rng.standard_normal(3),
            rng.standard_normal(n_j), rng.standard_normal(n_j)]
    ref = jax_controller.robot_state_to_generalized(*(jnp.asarray(a) for a in args))
    got = controller.robot_state_to_generalized(*args)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.0, atol=1e-12)


FORMULATIONS = {
    "centroidal": (interface.build_centroidal_mpc, jax_centroidal,
                   controller.CentroidalMrtController, jax_controller.CentroidalMrtController),
    "wb": (interface.build_wb_mpc, jax_wb, controller.WBMrtController,
           jax_controller.WBMrtController),
}


@pytest.fixture(scope="module", params=list(FORMULATIONS))
def setup(request):
    """(port controller, JAX controller, the port's policy after one solve,
    the initial state) of one formulation."""
    build, jax_setup, port_cls, jax_cls = FORMULATIONS[request.param]
    mpc = build(*interface.mpc_files(ASSETS / "toy_biped", request.param), **LOOP_KW,
                device="cpu", dtype=torch.float64)
    x0 = np.asarray(mpc.initial_state, dtype=float)
    mpc.runtime.advance(0.0, x0, np.zeros(4))
    port = port_cls(mpc.model, device="cpu", dtype=torch.float64)
    ref = jax_cls(jax_setup("toy_biped")[1])
    return port, ref, mpc.runtime.policy, x0


def _close(got, ref, what):
    for name in ("q_des", "qd_des", "kp", "kd", "ff_effort"):
        a, b = getattr(got, name), np.asarray(getattr(ref, name), dtype=np.float64)
        assert a.shape == b.shape, f"{what} {name}"
        limit = CTRL_TOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= limit, f"{what} {name}: {err:.3e} > {limit:.3e}"


def test_fallback_without_policy(setup):
    port, ref, _, x0 = setup
    rng = np.random.default_rng(5)
    for _ in range(2):
        x = x0 + 0.01 * rng.standard_normal(x0.shape)
        got = port.compute(0.0, x, None)
        _close(got, ref.compute(0.0, x, None), "policy=None")
        assert not got.kp.any() and not got.kd.any()
        assert np.isfinite(got.ff_effort).all() and np.abs(got.ff_effort).max() > 0


def test_compute_with_a_policy(setup):
    port, ref, pol, x0 = setup
    jpol = JaxPolicy(t0=pol.t0, dt=pol.dt, xs=pol.xs.copy(), us=pol.us.copy(),
                     contact_flags=pol.contact_flags.copy())
    rng = np.random.default_rng(6)
    for t in (0.0, 0.013, 0.1, 0.5):   # 0.5 s lies past the 0.32 s horizon
        x_obs = pol.evaluate(t)[0] + 0.01 * rng.standard_normal(x0.shape)
        got = port.compute(t, x_obs, pol)
        _close(got, ref.compute(t, x_obs, jpol), f"t={t}")
        np.testing.assert_array_equal(got.kp, np.full_like(got.kp, port.KP))
        tau = got.total_torque(x_obs[6:6 + got.kp.size], np.zeros_like(got.kp))
        assert np.isfinite(tau).all()


def test_controller_defaults_to_the_card(setup, monkeypatch):
    port = setup[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        type(port)(port.model)
