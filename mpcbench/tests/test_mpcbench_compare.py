"""The comparison's parts on synthetic inputs: the filter's possible picks,
the judging of an answer against the reference's branches, and the sample
in pairs."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from mpcbench import compare
from mpcbench.reference.mpc.runtime import Answer
from mpcbench.reference.solver.sqp import ladder_choices


def _mask(*bits):
    return torch.tensor(bits, dtype=torch.bool)


@pytest.mark.parametrize("nominal, surely, possibly, picks", [
    ((0, 1, 1), (0, 1, 1), (0, 1, 1), [1]),              # no tie: the nominal pick alone
    ((0, 1, 1), (0, 1, 1), (1, 1, 1), [1, 0]),           # the larger step nearly accepted
    ((0, 1, 1), (0, 0, 1), (0, 1, 1), [1, 2]),           # the pick nearly rejected
    ((0, 0, 0), (0, 0, 0), (0, 0, 1), [None, 2]),        # no step, or the last one
    ((1, 0, 0), (0, 0, 0), (1, 0, 0), [0, None]),        # the only accepted step a tie
])
def test_ladder_choices(nominal, surely, possibly, picks):
    assert ladder_choices(_mask(*nominal), _mask(*surely), _mask(*possibly)) == picks


def _answer(x, g=0.1, step=1.0, recovery=False, need=0.0):
    return Answer(xs=np.full((3, 2), x), us=np.full((2, 2), x), g_norm=g, step_size=step,
                  recovery=recovery, need=need)


def test_judge_takes_the_nearest_branch_with_the_same_decisions():
    leaves = [_answer(0.0), _answer(0.5, step=0.7, need=1e-5), _answer(0.51, recovery=True)]
    gap, k, same = compare.judge(_answer(0.5, step=0.7), leaves)
    assert (k, same) == (1, True) and gap < 1e-12
    # a branch that the tolerance does not reach is not taken: the nearest
    # of the rest, with other decisions
    gap, k, same = compare.judge(_answer(0.5, step=0.7), leaves, tol=1e-6)
    assert k == 2 and not same and gap == pytest.approx(0.01)
    # the max |g| counts as a gap
    gap, _, _ = compare.judge(_answer(0.0, g=0.4), leaves)
    assert gap == pytest.approx(0.3)
    # a policy that is not finite has an infinite gap
    bad = _answer(0.0)
    bad.us[1, 1] = math.nan
    assert compare.judge(bad, leaves)[0] == math.inf


@dataclasses.dataclass
class _S:
    episode: int
    step: int
    recovery: bool


def test_the_sample_comes_in_consecutive_pairs():
    rng = np.random.default_rng(0)
    solves = [_S(e, k, bool(rng.random() < 0.3)) for e in range(3) for k in range(50)]
    for seed in (1, 2, 2 ** 31 + 5):
        sample = compare.choose_sample(solves, 8, seed)
        assert sample == compare.choose_sample(solves, 8, seed)
        assert len(sample) == 8 and sample[:2] == [0, 1]
        ends = [j for j in sample if j - 1 in sample and compare.chained(solves, j)]
        assert len(ends) == 4
        assert sum(solves[j].recovery for j in ends[1:]) == 2
    assert compare.choose_sample(solves, 8, 1) != compare.choose_sample(solves, 8, 2)


@dataclasses.dataclass
class _W:
    xs: np.ndarray
    us: np.ndarray
    g_norm: float
    step_size: float
    recovery: bool
    contact_flags: np.ndarray


def test_a_gap_counts_over_what_float32_leaves_open():
    limit = compare.LIMITS["policy_gap_max"]
    flags = np.ones((3, 2))
    solves = [_W(np.full((3, 2), x), np.full((2, 2), x), 0.1, 1.0, False, flags)
              for x in (0.0, 10 * limit)]
    outs = {i: compare.Checked(leaves=[_answer(0.0)], contact_flags=flags) for i in (0, 1)}
    # twins that stay close: the whole gap counts
    assert compare.numbers(solves, outs)["policy_gap_max"] == pytest.approx(10 * limit)
    assert compare.numbers(solves, outs, twins={1: 0.1 * limit})["policy_gap_max"] == \
        pytest.approx(10 * limit)
    # twins that float32 rounding takes as far: the gap counts over it
    wide = compare.numbers(solves, outs, twins={1: 5 * limit})["policy_gap_max"]
    assert wide == pytest.approx(10 * limit / (compare.TWIN_K * 5)) and wide <= limit
    # the median is not scaled
    assert compare.numbers(solves, outs, twins={1: 5 * limit})["policy_gap_median"] == \
        pytest.approx(5 * limit)
