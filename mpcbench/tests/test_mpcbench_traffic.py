"""The closed-loop traffic: one seed repeats exactly, two seeds differ, and
every seed gets the same episodes (gaits, commands, requests)."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from mpcbench import harness
from mpcbench.tests.small import HOME, benchmark

NX = 5


class _Runtime:
    """Stands in for `MpcRuntime`: records what `advance` is handed and
    answers with a policy that holds the observed state."""

    def __init__(self):
        self.calls = []
        self.n_warm_resets = 0
        self.policy = None

    def reset(self):
        self.calls.append(("reset",))

    def advance(self, t, x_obs, cmd):
        self.calls.append(("advance", t, np.array(x_obs), np.array(cmd)))
        x = np.array(x_obs)
        self.policy = types.SimpleNamespace(
            xs=np.tile(x, (3, 1)), us=np.zeros((2, 2)), contact_flags=np.ones((3, 2)),
            evaluate=lambda t: (x + 0.01, None, None))
        return types.SimpleNamespace(solve_time=0.0, reference_time=0.0, iterations=2,
                                     recovery=False, g_norm=0.0, step_size=1.0)


class _MotionManager:
    def __init__(self, calls):
        self.calls = calls

    def request_gait(self, name):
        self.calls.append(("gait", name))


def _program(hz=10.0):
    rt = _Runtime()
    mpc = types.SimpleNamespace(runtime=rt, motion_manager=_MotionManager(rt.calls),
                                initial_state=np.zeros(NX))
    return types.SimpleNamespace(runtime=rt, mpc=mpc, config={"mpc_hz": hz})


def _drive(seed, n):
    cell = harness.Cell(benchmark(later=True), "wb-walk")
    driver = cell.driver()
    program = _program()
    loop = driver.Loop(program, cell.traffic, seed)
    solves = [loop.step() for _ in range(n)]
    return program.runtime.calls, solves, cell.traffic, loop


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v)


def test_one_seed_repeats_exactly():
    a, _, _, _ = _drive(2 ** 31 + 99, 75)
    b, _, _, _ = _drive(2 ** 31 + 99, 75)
    _same(a, b)


def test_two_seeds_differ_in_the_noise_only():
    a, sa, _, _ = _drive(5, 75)
    b, sb, _, _ = _drive(6, 75)
    xa = np.array([c[2] for c in a if c[0] == "advance"])
    xb = np.array([c[2] for c in b if c[0] == "advance"])
    assert not np.array_equal(xa, xb)
    # the same episodes: times, commands and gait requests
    assert [c for c in a if c[0] == "gait"] == [c for c in b if c[0] == "gait"]
    np.testing.assert_array_equal([s.cmd for s in sa], [s.cmd for s in sb])
    np.testing.assert_array_equal([s.t for s in sa], [s.t for s in sb])


def test_episodes_follow_the_traffic_file():
    calls, solves, traffic, loop = _drive(1, 2 * 30 + 5)
    hz = 10.0
    ep = traffic["episode"]
    n_stance, n_walk = round(ep["stance_s"] * hz), round(ep["walk_s"] * hz)
    n_total = n_stance + n_walk + round(ep["stance_end_s"] * hz)
    assert loop.n_total == n_total
    gaits = [c[1] for c in calls if c[0] == "gait"]
    assert gaits[:4] == [traffic["gaits"][0], "stance", traffic["gaits"][1], "stance"]
    for s in solves:
        assert s.t == pytest.approx(s.step / hz)
        walking = n_stance <= s.step < n_stance + n_walk
        gait = traffic["gaits"][s.episode % len(traffic["gaits"])]
        expect = traffic["commands"][gait] if walking else [0.0] * 4
        np.testing.assert_array_equal(s.cmd, expect)
    # each episode starts from a reset runtime, at the initial state plus noise
    assert sum(c[0] == "reset" for c in calls) == 3
    first = [s for s in solves if s.step == 0]
    assert all(np.abs(s.x_obs).max() < 10 * traffic["obs_noise_std"] for s in first)


def test_traffic_file_is_data():
    t = json.loads((HOME / "traffic" / "walk-cmds.json").read_text())
    assert (HOME / "drivers" / f"{t['driver']}.py").is_file()
    assert set(t["commands"]) >= set(t["gaits"])
