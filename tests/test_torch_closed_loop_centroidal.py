"""PyTorch port, the centroidal closed loop against the JAX package:
`build_centroidal_mpc` + `run_dummy_sim` on `toy_biped` (N = 8 over 0.32 s,
50 Hz plant, 25 Hz MPC, f64, the committed info files), per tick, for a
stance run and a run with a trot override; one tick forced into each
divergence-recovery branch (soft: the recovery solver from the shifted warm
start; hard: from the WeightCompInitializer trajectory); one float32 tick.

Tolerances: per tick, states, inputs, cost and g_norm 1e-8 max(1, max|ref|),
contact flags and step sizes equal; the float32 tick 2e-3 max(1, max|ref|)
against JAX's float64 tick (tests/test_torch_common.py, closed-loop part)."""

from __future__ import annotations

import pytest

from tests.test_torch_common import LOOP_CASES, NO_BATCHING_FALLBACK, LoopPair, check_loop_case

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)


@pytest.fixture(scope="module")
def pair():
    return LoopPair("centroidal")


@pytest.mark.parametrize("case", LOOP_CASES)
def test_closed_loop_matches_jax(pair, case):
    check_loop_case(pair, case)


def test_gains_service_rebuilds_the_solvers(pair):
    """GainsReceiver analogue (JAX tests/test_dummy_sim.py::
    test_gains_service_live_update): a Q update between solves rebuilds both
    solvers from the mutated config, and the next solve uses the new weights."""
    import numpy as np

    from wb_humanoid_mpc_tpu_torch.mpc.gains import GainUpdate

    mpc = pair.port
    rt = mpc.runtime
    rt.reset()
    x0 = np.asarray(mpc.initial_state, dtype=float)
    s1 = rt.advance(0.0, x0, np.zeros(4))
    old = (rt.solve_fn, rt.recovery_solve_fn)
    q_orig = np.array(mpc.cfg.Q, copy=True)
    try:
        q_new = q_orig.copy()
        q_new[8] *= 100.0   # re-price base-height tracking
        mpc.gains.apply(GainUpdate(term="Q", values=q_new))
        assert rt.solve_fn is not old[0] and rt.recovery_solve_fn is not old[1]
        rt.reset()
        s2 = rt.advance(0.0, x0, np.zeros(4))
        sqrt_q = mpc.ocp._consts(rt.device, rt.dtype).sqrt_Q.numpy()
        np.testing.assert_allclose(sqrt_q, np.sqrt(q_new))
        assert np.isfinite(s2.cost) and s2.g_norm < 5e-2
        assert s2.cost != s1.cost
    finally:
        mpc.gains.apply(GainUpdate(term="Q", values=q_orig))
        rt.reset()
