"""The centroidal MuJoCo stance on humanoid23, the port's loop against the
JAX package's, on the CPU in float64: `build_centroidal_mpc` at N = 28 (the
task's 1.2 s horizon), `run_mujoco_closed_loop` synchronous at 500 Hz MRT
and 25 Hz MPC (2 kHz physics), zero command, on `assets/humanoid23`'s MJCF.

- The first 1.0 s: tick by tick, base and joint positions, the solves' cost
  and g_norm within MUJOCO_LOOP_TOL x max(1, max|ref|), the same step sizes,
  no reset in either (tests/test_torch_common.py::check_mujoco_loop).
- 3 s (slow, ~14 min): the JAX package's loop falls too (at least one
  reset in each), so the fall belongs to the robot or the centroidal
  formulation, not to the port. The two agree tick by tick, at the same
  tolerance, for the first 1.4 s. After that the robot, which has rocked
  back and forth since ~0.7 s, goes down: it amplifies their roundoff about
  tenfold every 0.15 s (3e-14 at 0.7 s, 6e-10 at 1.44 s), and at 1.48 s the
  two filter line searches take different steps on the falling robot.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_common import (
    ASSETS,
    NO_BATCHING_FALLBACK,
    assert_mujoco_logs_close,
    check_mujoco_loop,
    mujoco_pair_runs,
)
from wb_humanoid_mpc_tpu_torch import interface as port_interface

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

ROBOT = "humanoid23"
RATES = dict(mrt_frequency=500.0, mpc_frequency=25.0)
AGREE_FOR_S = 1.4   # the 3 s run: tick-by-tick agreement before the fall


@pytest.fixture(scope="module")
def pair():
    from wb_humanoid_mpc_tpu import interface as jax_interface

    files = port_interface.mpc_files(ASSETS / ROBOT, "centroidal")
    return (jax_interface.build_centroidal_mpc(*files, n_nodes=28),
            port_interface.build_centroidal_mpc(*files, n_nodes=28, device="cpu",
                                                dtype=torch.float64))


def test_stance_first_second_matches_jax(pair):
    check_mujoco_loop("centroidal", pair, "sync", ROBOT, dict(duration=1.0, **RATES))


@pytest.mark.slow
def test_stance_falls_in_both_packages(pair):
    got, ref = mujoco_pair_runs("centroidal", pair, "sync", ROBOT, dict(duration=3.0, **RATES))
    assert ref.n_resets >= 1, "JAX's loop stood 3 s: the port's fall would be its own"
    assert got.n_resets >= 1
    assert_mujoco_logs_close(got, ref, f"{ROBOT} centroidal, the first {AGREE_FOR_S} s",
                             n_ticks=round(AGREE_FOR_S * RATES["mrt_frequency"]),
                             n_solves=round(AGREE_FOR_S * RATES["mpc_frequency"]))
