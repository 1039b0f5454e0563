"""PyTorch port, the whole-body closed loop against the JAX package:
`build_wb_mpc` + `run_dummy_sim` on `toy_biped` (N = 8 over 0.32 s,
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
    return LoopPair("wb")


@pytest.mark.parametrize("case", LOOP_CASES)
def test_closed_loop_matches_jax(pair, case):
    check_loop_case(pair, case)
