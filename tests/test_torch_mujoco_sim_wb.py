"""The port's whole-body MuJoCo closed loop against the JAX package's:
`run_mujoco_closed_loop` on toy_biped (N = 8, 0.2 s: 100 Hz MRT, 25 Hz MPC,
2 kHz physics), float64 on the CPU, synchronous and with `solve_latency =
0.012`, held tick by tick (base and joint positions, the solves' cost and
g_norm within MUJOCO_LOOP_TOL x max(1, max|ref|) of tests/test_torch_common.py,
the same step sizes, no reset). A file of its own so that it runs beside the
centroidal loops of tests/test_torch_mujoco_sim.py: each waits on JAX's
compile of its solver."""

from __future__ import annotations

import pytest

from tests.test_torch_common import NO_BATCHING_FALLBACK, build_pair, check_mujoco_loop

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)


@pytest.fixture(scope="module")
def wb_pair():
    return build_pair("wb")


@pytest.mark.parametrize("mode", ["sync", "latency"])
def test_wb_closed_loop_matches_jax(wb_pair, mode):
    check_mujoco_loop("wb", wb_pair, mode)
