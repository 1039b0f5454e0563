"""The plain reference against the port, and the check against planted
faults, on the CPU in float64 at 4 nodes: the whole run of a cell (set-up,
warm-up, window, check) with the card's look left out."""

from __future__ import annotations

import time

import pytest
import torch

from mpcbench import harness
from mpcbench.tests.small import benchmark, small_home


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    return small_home(tmp_path_factory.mktemp("mpcbench_small"), n_nodes=4)


def run_cell(home, workload, sabotage=None, seconds=2.0, seed=2 ** 31 + 7):
    cell = harness.Cell(benchmark(later=True), workload, home)
    driver = cell.driver()
    result, checks = driver.run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                                dtype=torch.float64, sabotage=sabotage)
    return result, checks


@pytest.mark.parametrize("workload", ["wb-walk", "cen-walk"])
def test_reference_matches_port_in_float64(home, workload):
    result, checks = run_cell(home, workload)
    assert result.solves and result.checked
    assert checks["policy_gap_median"][0] < 1e-9
    assert checks["policy_gap_max"][0] < 1e-9
    assert checks["decision_mismatches"][0] == 0
    assert checks["contact_mismatches"][0] == 0
    assert checks["nonfinite_policies"][0] == 0
    assert all(v <= limit for v, limit in checks.values())
    # the sample comes in pairs of consecutive solves
    assert len(result.checked) % 2 == 0 and len(result.checked) >= 2


def _unchanged(program):
    """Every solve returns its warm start: a step that leaves the state as
    it was."""
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolution

    def solve(t0, x0, traj, params, lam):
        zero = torch.zeros((), dtype=x0.dtype, device=x0.device)
        return SqpSolution(traj=traj, lam=lam, cost=zero, g_norm=zero, defect_norm=zero,
                           step_size=zero + 1.0, iterations=2)

    program.runtime.solve_fn = program.runtime.recovery_solve_fn = solve


def _altered(program):
    """One input of each policy altered where the solve produces it."""
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    rt = program.runtime
    for attr in ("solve_fn", "recovery_solve_fn"):
        orig = getattr(rt, attr)

        def solve(*args, orig=orig):
            sol = orig(*args)
            us = sol.traj.us.clone()
            us[0, -1] += 0.01
            return sol._replace(traj=Trajectory(xs=sol.traj.xs, us=us))

        setattr(rt, attr, solve)


def _wrap(program, change):
    """Each solve's solution passed through change(solution, count), count
    the solves so far."""
    rt = program.runtime
    count = [0]
    for attr in ("solve_fn", "recovery_solve_fn"):
        orig = getattr(rt, attr)

        def solve(*args, orig=orig):
            count[0] += 1
            return change(orig(*args), count[0])

        setattr(rt, attr, solve)


def _altered_once(program):
    """The answer of the window's first solve alone altered, by 0.05: one
    wrong solve among the sampled ones."""
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    def change(sol, n):
        if n != 1:
            return sol
        xs = sol.traj.xs.clone()
        xs[-1, 0] += 0.05
        return sol._replace(traj=Trajectory(xs=xs, us=sol.traj.us))

    _wrap(program, change)


def _g_misreported(program):
    """Every solve reports its max |g| 2 too high, which sends the next solve
    down the recovery path."""
    _wrap(program, lambda sol, n: sol._replace(g_norm=sol.g_norm + 2.0))


def _nonfinite_once(program):
    """The third solve of the window, past the first pair that the check
    samples, returns a policy that is not finite."""
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    def change(sol, n):
        if n != 3:
            return sol
        us = sol.traj.us.clone()
        us[3, 0] = float("nan")
        return sol._replace(traj=Trajectory(xs=sol.traj.xs, us=us))

    _wrap(program, change)


@pytest.mark.parametrize("fault, caught_by", [
    (_unchanged, "policy_gap_median"), (_altered, "policy_gap_median"),
    (_altered_once, "policy_gap_max"), (_g_misreported, "policy_gap_max"),
    (_nonfinite_once, "nonfinite_policies")],
    ids=["state-unchanged", "answer-altered", "one-answer-altered", "g-misreported",
         "one-policy-nonfinite"])
def test_planted_fault_is_not_correct(home, fault, caught_by):
    result, checks = run_cell(home, "cen-walk", sabotage=fault)
    assert not all(v <= limit for v, limit in checks.values())
    value, limit = checks[caught_by]
    assert value > limit
