"""PyTorch port, the whole-body MPC against the benchmark's plain reference
(`mpcbench/reference/`) on the CPU: its closed loop in float64 over a fixed
number of solves, and one saved solve of the benchmark's cell in float64
and float32 (`tests/_saved_solve.py`).

The port's whole-body MPC of the benchmark's configuration
(`mpcbench/configs/humanoid23-wb.json`, its task file's horizon cut to 4
nodes), run eagerly, and the reference MPC built from the same files are
handed the same observations, commands and gait requests: the benchmark's
own walking traffic (`mpcbench/traffic/walk-cmds.json`, its first
episode cut short: stance, walk, stance), each observation the port's last
policy at the next tick plus seeded noise. Each side warm-starts from its own last
answer, so the two loops run apart from the first solve on; in float64
every policy agrees to 1e-9 and every recovery decision and contact flag
is the same. The saved solve, at the full 29 nodes: the port's eager
solve agrees with the reference to 1e-9 in float64, and in float32 (the
plain LQ solve and FK pass that the CPU runs) stays well inside the
benchmark's limit, as its twins did on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpcbench import compare, harness
from mpcbench.tests.small import benchmark, small_home
from tests import _saved_solve as saved
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

N_NODES = 4
SEED = 2 ** 31 + 4101
# the episode cut short: 6 solves of stance, 18 of the walk command, 6 of stance
EPISODE = {"stance_s": 0.1, "walk_s": 0.3, "stance_end_s": 0.1}


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    home = small_home(tmp_path_factory.mktemp("wb_small"), n_nodes=N_NODES)
    cell = harness.Cell(benchmark(), "wb-walk", home)
    cell.traffic = dict(cell.traffic, episode=EPISODE)
    mpc_loop = cell.driver()
    program = mpc_loop.Program(cell, device="cpu", dtype=torch.float64)
    ref = compare.reference_for(cell, torch.device("cpu"), torch.float64)
    return cell, mpc_loop, program, ref


def _run(cell, mpc_loop, program, ref, episodes: int):
    """The port's closed loop over `episodes` episodes and, beside it, the
    reference handed the same inputs: [(port's solve, reference's stats,
    reference's policy)]."""
    loop = mpc_loop.Loop(program, cell.traffic, SEED)
    rt, mm = ref.runtime, ref.motion_manager
    out = []
    while True:
        if loop.k >= loop.n_total:
            if loop.episode + 1 == episodes:
                return out
            rt.reset()
        s = loop.step()
        if s.gait_request is not None:
            mm.request_gait(s.gait_request)
        with torch.no_grad():
            stats = rt.advance(s.t, s.x_obs, s.cmd)
        out.append((s, stats, rt.policy))


def test_port_matches_the_reference_over_closed_loop_solves(loops):
    cell, mpc_loop, program, ref = loops
    solves = _run(cell, mpc_loop, program, ref, episodes=1)
    assert len(solves) == 30
    assert {s.gait_request for s, _, _ in solves} == {None, "walk", "stance"}
    for s, stats, pol in solves:
        where = (s.episode, s.step)
        assert compare.policy_gap(s.xs, s.us, pol.xs, pol.us) < 1e-9, where
        assert abs(s.g_norm - stats.g_norm) < 1e-9 * max(1.0, abs(stats.g_norm)), where
        assert s.step_size == stats.step_size, where
        assert bool(s.recovery) == bool(stats.recovery), where
        assert s.iterations == (12 if stats.recovery else 2), where
        assert np.array_equal(np.asarray(s.contact_flags), np.asarray(pol.contact_flags)), where
    # the walk leaves both feet in contact at some nodes and one foot at others
    flags = np.concatenate([np.asarray(s.contact_flags) for s, _, _ in solves])
    assert (flags.sum(axis=1) == 1).any() and (flags.sum(axis=1) == 2).any()


@pytest.fixture(scope="module")
def saved_reference():
    return saved.reference_answer("cpu")


@pytest.mark.parametrize("dtype, limit", [(torch.float64, 1e-9),
                                          (torch.float32, compare.LIMITS["policy_gap_max"] / 4)],
                         ids=["f64", "f32"])
def test_saved_solve_matches_the_reference(saved_reference, dtype, limit):
    mpc = interface.build_wb_mpc(*saved.files(saved.cell()), device="cpu", dtype=dtype)
    sol = mpc.runtime.solve_fn(*saved.inputs(Trajectory, WBNodeParams, dtype, "cpu"))
    assert sol.iterations == saved.iterations() == 2
    assert saved.gap(sol, saved_reference) < limit
    assert float(sol.step_size) == pytest.approx(saved_reference.step_size, abs=1e-6)
