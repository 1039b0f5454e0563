"""What decides `correct`: the program's answers held against the plain
reference (`reference/`), solve by solve.

Each solve warm-starts from the previous answer, so the check takes the
sampled solves in pairs of consecutive solves. Each starts from the
program's previous policy (the program's own state, which the check holds
against the reference where that solve is sampled: the first of a pair's
policy is checked itself). The first of a pair takes its recovery decision
from the program's previous max |g| and step, the second from the max |g|
and step of the reference's own answer to the first. (Starting the second
from the reference's own policy as well would hold the program to a solve
that is not its: a 12-iteration recovery solve that does not converge
turns a start 1.4e-4 away into answers 1.6e-2 apart, with every step of
the ladder the same on both sides.) From there the reference does
all the rest again from the inputs the traffic handed to both sides (time,
observed state, command, gait requests): the reference pipeline, replayed
over the episode from its start, its node params, the warm-start shift, the
recovery decision, and the SQP solve (linearization with the FK pass,
projection, Riccati solve, filter line search, step). An episode's first
solve starts from no state at all.

The filter line search and the recovery decision are comparisons: where
one lies within rounding of its threshold, a float32 program may take
either side, and the two answers can differ by a whole step of the ladder.
So the reference answers with every branch that its decisions reach when
each may fall either way within `BRANCH_TOL` (the line search) or `G_TOL`
(the recovery decision's max |g|), the nominal answer first
(`MpcRuntime.advance(branch_tols=...)`), and a solve is judged against the
branch nearest to it. Away from such ties there is one branch.

A solve's gap against a branch: the widest of the policy's (xs, us) column
gaps, each over max(1, its largest |reference| value), and the gap of max
|g| over max(1, |g|).

Some solves do not converge (a 12-iteration recovery that ends with max
|g| near 0.5): there float32 rounding alone moves the answer by 1e-2 and
more, on either side. Where a solve's gap is over the limit, the check
reads how far float32 takes that solve in the reference itself: the
plain reference in float32, on the card and on the CPU, started as the
reference was (`twin_gaps`). That solve's gap counts over
max(1, TWIN_K x the twins' widest gap / the limit). A solve whose twins
stay close to the reference keeps its whole gap.

Numbers compared, each with its limit (`LIMITS`; the readings they were
set from are in PERF.md):
  policy_gap_max       the widest gap over the sampled solves, each
                       counted as above;
  policy_gap_median    the median gap over the sampled solves;
  decision_mismatches  sampled solves that no branch with the program's
                       recovery decision and last step matches;
  contact_mismatches   contact flags of the sampled policies that differ;
  nonfinite_policies   solves of the window whose policy is not finite.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpcbench.reference.build import build_reference
from mpcbench.reference.mpc.runtime import Answer

# the limit of each number compared (PERF.md gives the readings they were
# set from)
LIMITS = {"policy_gap_max": 1.2e-2, "policy_gap_median": 2e-3, "decision_mismatches": 0,
          "contact_mismatches": 0, "nonfinite_policies": 0}
BRANCH_TOL = 1e-3     # relative, on a line-search candidate's cost and violation
G_TOL = 0.05          # relative, on the max |g| that decides the recovery path
MAX_LEAVES = 8        # branches a solve at the most
MIN_SPLIT = 1e-4      # a branch moves the iterate this far or more, in the gap's measure
TWIN_K = 3.0          # a solve's gap over max(1, TWIN_K x its float32 twins' gap / limit)


def policy_gap(xs, us, ref_xs, ref_us) -> float:
    """max over columns of max |program - reference| / max(1, max |reference|)."""
    worst = 0.0
    for a, r in ((xs, ref_xs), (us, ref_us)):
        a, r = np.asarray(a, dtype=np.float64), np.asarray(r, dtype=np.float64)
        if not (np.isfinite(a).all() and np.isfinite(r).all()):
            return math.inf
        scale = np.maximum(1.0, np.abs(r).max(axis=0))
        worst = max(worst, float((np.abs(a - r) / scale).max()))
    return worst


def answer_gap(ans, ref) -> float:
    """The gap of answer `ans` against the reference answer `ref`."""
    g, g_ref = float(ans.g_norm), float(ref.g_norm)
    if not (math.isfinite(g) and math.isfinite(g_ref)):
        return math.inf
    return max(policy_gap(ans.xs, ans.us, ref.xs, ref.us), abs(g - g_ref) / max(1.0, abs(g_ref)))


def same_decisions(ans, ref) -> bool:
    """The same recovery decision and the same last step of the ladder."""
    return (bool(ans.recovery) == bool(ref.recovery)
            and abs(float(ans.step_size) - float(ref.step_size)) <= 1e-6)


def judge(ans, leaves, tol: float = math.inf) -> tuple[float, int, bool]:
    """(gap, index of the branch, same decisions) of answer `ans` against the
    nearest of the reference's branches `leaves` that `tol` reaches: the
    nearest among those with the program's decisions, if any."""
    best = None
    for k, leaf in enumerate(leaves):
        if leaf.need > tol:
            continue
        same = same_decisions(ans, leaf)
        key = (not same, answer_gap(ans, leaf), k)
        if best is None or key < best:
            best = key
    mismatch, gap, k = best
    return gap, k, not mismatch


def program_answer(solve) -> Answer:
    return Answer(xs=solve.xs, us=solve.us, g_norm=solve.g_norm, step_size=solve.step_size,
                  recovery=solve.recovery)


def chained(solves, i: int) -> bool:
    """Solve i follows solve i - 1 in the same episode."""
    return (i >= 1 and solves[i].episode == solves[i - 1].episode
            and solves[i].step == solves[i - 1].step + 1)


def choose_sample(solves, n: int, seed: int) -> list[int]:
    """Indices (into `solves`) of the solves to check, drawn from the seed,
    in pairs of consecutive solves: the window's first two, then pairs that
    end in a recovery solve (whose recovery decision follows from the
    reference's own answer to the first) for up to half of the rest, and
    pairs that end in a plain solve."""
    if not solves:
        return []
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    chosen = {0} | ({1} if len(solves) > 1 and chained(solves, 1) else set())
    ends = [j for j in range(2, len(solves)) if chained(solves, j)]
    pairs = max(0, (n - len(chosen)) // 2)
    pools = [[j for j in ends if solves[j].recovery], [j for j in ends if not solves[j].recovery]]
    want = [min(len(pools[0]), pairs - pairs // 2), 0]
    want[1] = pairs - want[0]
    for pool, k in zip(pools, want):
        for j in rng.permutation(pool):
            if k <= 0:
                break
            j = int(j)
            if j in chosen or j - 1 in chosen:
                continue
            chosen.update((j - 1, j))
            k -= 1
    return sorted(chosen)


@dataclasses.dataclass
class Checked:
    """The reference's answers to one sampled solve: its branches (the
    nominal answer first), the contact flags of its policy, and what its
    recovery decision was taken from."""
    leaves: list
    contact_flags: np.ndarray
    decide: tuple | None = None    # the (max |g|, step) its recovery decision took


def replay(ref, solves, sample: list[int], judged: dict | None = None, branch_tols=None,
           tol: float = math.inf, decisions: dict | None = None) -> dict:
    """{index: Checked} of the reference over the sampled solves. Each
    episode that holds a sampled solve is replayed from its first solve: the
    reference pipeline sees every observation, and the solver runs where a
    solve is sampled, warm-started from the program's previous policy. A
    sampled solve that follows a sampled solve takes its recovery decision
    from the max |g| and step of the reference's own answer to that one (the
    branch nearest to the judged answer there, `judged`: {index: Answer}, by
    default the program's, among the branches within `tol`), or from
    `decisions` ({index: (max |g|, step)}, a replay's `Checked.decide`)."""
    judged = judged or {i: program_answer(solves[i]) for i in sample}
    rt, mm = ref.runtime, ref.motion_manager
    wanted = set(sample)
    out = {}
    by_episode: dict[int, list[int]] = {}
    for i, s in enumerate(solves):
        by_episode.setdefault(s.episode, []).append(i)
    for episode, idx in sorted(by_episode.items()):
        last = max((i for i in idx if i in wanted), default=None)
        if last is None:
            continue
        if solves[idx[0]].step != 0:
            raise ValueError(f"episode {episode} does not start in the records")
        rt.reset()
        prev = None
        for i in idx:
            s = solves[i]
            if s.gait_request is not None:
                mm.request_gait(s.gait_request)
            if i in wanted:
                decide = None
                if prev is None:
                    rt._traj, rt._last_t = None, None
                    rt._last_g, rt._last_alpha = 0.0, 1.0
                else:
                    # the warm start: the program's previous policy (checked
                    # itself where that solve is sampled too); the recovery
                    # decision: the reference's own max |g| and step there
                    decide = (prev.g_norm, prev.step_size)
                    if decisions is not None:
                        decide = decisions[i]
                    elif i - 1 in out and chained(solves, i):
                        leaves = out[i - 1].leaves
                        leaf = leaves[judge(judged[i - 1], leaves, tol)[1]]
                        decide = (leaf.g_norm, leaf.step_size)
                    rt._traj = (np.asarray(prev.xs, dtype=np.float64),
                                np.asarray(prev.us, dtype=np.float64))
                    rt._last_t = prev.t
                    rt._last_g, rt._last_alpha = decide
                with torch.no_grad():
                    stats = rt.advance(s.t, s.x_obs, s.cmd, branch_tols=branch_tols, g_tol=G_TOL,
                                       max_leaves=MAX_LEAVES, min_split=MIN_SPLIT)
                pol = rt.policy
                leaves = (rt.leaves if branch_tols is not None else
                          [Answer(xs=pol.xs, us=pol.us, g_norm=stats.g_norm,
                                  step_size=stats.step_size, recovery=stats.recovery)])
                out[i] = Checked(leaves=leaves, contact_flags=pol.contact_flags, decide=decide)
            else:
                dt_since = 0.0 if prev is None else max(s.t - prev.t, 1e-4)
                base_vel = np.asarray(rt.base_vel_extractor(np.asarray(s.x_obs)))
                mm.pre_solve(s.t, s.x_obs, s.cmd, dt_since, base_vel, 0.0)
            prev = s
            if i == last:
                break
    return out


def check(cell, solves, sample: list[int], device, dtype=torch.float64, tf32=False, ref=None,
          judged: dict | None = None, branch_tols=(BRANCH_TOL,), tol: float = BRANCH_TOL,
          twins: bool = True):
    """(numbers, reference outputs, twin gaps): the numbers compared over
    the sampled solves of the program (or the answers `judged`) against the
    reference built in `dtype` on `device` (or `ref`, one built before),
    with TF32 matrix products when `tf32`, answering with its branches
    within `branch_tols` (None: its nominal answer only); with `twins`, the
    float32 twins' gaps at the solves whose gap is over the limit."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        ref = ref or reference_for(cell, device, dtype)
        outs = replay(ref, solves, sample, judged, branch_tols, tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    over = [i for i, g in gaps(solves, outs, judged, tol).items()
            if g > LIMITS["policy_gap_max"]]
    d = twin_gaps(cell, solves, outs, over, device, tol) if twins and over else {}
    return numbers(solves, outs, judged, tol, d), outs, d


def twin_gaps(cell, solves, outs: dict, flagged: list[int], device, tol: float) -> dict:
    """{index: d}: at each flagged solve, the widest gap of the float32
    twins of the reference, the plain reference in float32 on `device`
    (TF32 off) and on the CPU, started as the reference was, against the
    reference's branches: how far float32 rounding alone takes that solve's
    answer."""
    out = {i: 0.0 for i in flagged}
    decisions = {i: outs[i].decide for i in flagged}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in dict.fromkeys([torch.device(device), torch.device("cpu")]):
            twin = reference_for(cell, dev, torch.float32)
            got = replay(twin, solves, flagged, decisions=decisions)
            for i in flagged:
                out[i] = max(out[i], judge(got[i].leaves[0], outs[i].leaves, tol)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return out


def reference_for(cell, device, dtype):
    c = cell.config
    ref = build_reference(c["formulation"], str(cell.path(c["urdf"])), str(cell.path(c["task"])),
                          str(cell.path(c["reference"])), str(cell.path(c["gait"])),
                          device=device, dtype=dtype)
    if ref.n_nodes != c["n_nodes"]:
        raise ValueError(f"reference grid {ref.n_nodes} nodes, config {c['n_nodes']}")
    return ref


def gaps(solves, outs: dict, judged: dict | None = None, tol: float = math.inf) -> dict:
    """{index: gap} of the judged answers (default: the program's) against
    the reference's branches within `tol`."""
    judged = judged or {i: program_answer(solves[i]) for i in outs}
    return {i: judge(judged[i], o.leaves, tol)[0] for i, o in outs.items()}


def numbers(solves, outs: dict, judged: dict | None = None, tol: float = math.inf,
            twins: dict | None = None) -> dict:
    """The numbers compared, from the window's solves and the reference's
    answers at the sampled ones, for the judged answers (default: the
    program's; a control's answers are given here); `twins`, the float32
    twins' gaps where they were read (`twin_gaps`)."""
    judged = judged or {i: program_answer(solves[i]) for i in outs}
    verdicts = {i: judge(judged[i], o.leaves, tol) for i, o in outs.items()}
    g = [v[0] for v in verdicts.values()]
    twins = twins or {}
    scaled = [v[0] / max(1.0, TWIN_K * twins.get(i, 0.0) / LIMITS["policy_gap_max"])
              for i, v in verdicts.items()]
    return {
        "policy_gap_max": max(scaled) if scaled else 0.0,
        "policy_gap_median": float(np.median(g)) if g else 0.0,
        "decision_mismatches": sum(int(not v[2]) for v in verdicts.values()),
        "contact_mismatches": sum(
            int(np.count_nonzero(np.asarray(o.contact_flags) != np.asarray(solves[i].contact_flags)))
            for i, o in outs.items()),
        "nonfinite_policies": sum(int(not (np.isfinite(s.xs).all() and np.isfinite(s.us).all()))
                                  for s in solves),
    }
