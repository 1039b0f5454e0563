"""The walk-forward scenario of tests/test_dummy_sim.py::test_dummy_sim_walk_forward
on humanoid23, on the CPU in float64: centroidal, N = 50 nodes of 0.02 s,
2 SQP iterations a solve, the walk gait requested up front, the operator
command (a soft-start forward ramp to 0.1 m/s from t = 0.2 s and a heading
hold through wz), 50 Hz plant and MPC.

- The first 0.5 s (the walk's insertion into the gait schedule included;
  the first foot lifts at 1.0 s, inside every horizon from t = 0):
  the port's `run_dummy_sim` against the JAX package's, tick by tick, at the
  closed-loop tests' LOOP_TOL x max(1, max|ref|), the same contact flags and
  step sizes.
- 3 s of the port alone (slow, ~5 min): the walk gates of the JAX test. All
  hold as written but the displacement, which is derived from the JAX
  package's run of this scenario on humanoid23 (0.0887 m in 3 s): the JAX
  test's gate keeps the ratio 0.10 / 0.164 of the G1 run it was set from, so
  here 0.0887 x 0.10 / 0.164 = 0.054 m.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, LOOP_TOL, NO_BATCHING_FALLBACK, assert_loop_close
from wb_humanoid_mpc_tpu_torch import interface as port_interface

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

MPC_KW = dict(n_nodes=50, dt_override=0.02, sqp_iterations=2)
MIN_DISPLACEMENT = 0.0887 * 0.10 / 0.164   # m in 3 s: JAX's humanoid23 run x the G1 gate's ratio


def _files():
    return port_interface.mpc_files(ASSETS / "humanoid23", "centroidal")


def _walk(mpc, run_dummy_sim, duration: float):
    """tests/test_dummy_sim.py's walk: the gait up front, ramp + heading hold."""
    mpc.runtime.reset()
    mpc.motion_manager.request_gait("walk")

    def command_fn(t):
        ramp = float(np.clip((t - 0.2) / 1.0, 0.0, 1.0)) * 0.1
        yaw = 0.0
        if mpc.runtime.policy is not None:
            yaw = float(mpc.runtime.policy.xs[0, 9])
        wz = float(np.clip(-1.5 * yaw, -0.3, 0.3))
        return np.array([ramp, 0.0, 0.0, wz])

    return run_dummy_sim(mpc.runtime, mpc.initial_state, duration=duration, mrt_frequency=50.0,
                         mpc_frequency=50.0, command_fn=command_fn, flow=mpc.model.flow_map)


def _port_mpc():
    return port_interface.build_centroidal_mpc(*_files(), **MPC_KW, device="cpu",
                                               dtype=torch.float64)


def test_walk_first_half_second_matches_jax():
    from wb_humanoid_mpc_tpu import interface as jax_interface
    from wb_humanoid_mpc_tpu.sim.dummy import run_dummy_sim as jax_run_dummy_sim
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim

    ref = _walk(jax_interface.build_centroidal_mpc(*_files(), **MPC_KW), jax_run_dummy_sim, 0.5)
    got = _walk(_port_mpc(), run_dummy_sim, 0.5)
    assert_loop_close(got, ref, "humanoid23 walk, the first 0.5 s", LOOP_TOL)


@pytest.mark.slow
def test_walk_forward_gates():
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim

    log = _walk(_port_mpc(), run_dummy_sim, 3.0)
    xs = log.states
    assert np.isfinite(xs).all()
    disp = float(np.linalg.norm(xs[-1, 6:8] - xs[0, 6:8]))
    assert disp > MIN_DISPLACEMENT, f"only displaced {disp:.3f} m under a forward command"
    assert xs[:, 8].min() > 0.5, f"height collapsed to {xs[:, 8].min():.3f}"
    assert np.abs(xs[:, 10:12]).max() < 1.6   # no tumble
    single_support = (log.contact_flags.sum(axis=1) < 2).mean()
    assert single_support > 0.15, "no single-support phases seen"
    assert (log.contact_flags < 0.5).any()
