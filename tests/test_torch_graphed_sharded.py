"""PyTorch port, the compiled sharded solve (`solver/graphs.py::
GraphedShardedSolve`, `make_sharded_sqp_solver`'s default on the card) on the
CPU, against its eager twin (`graphs=False`, `ShardedSqp.solve`).

The runner of the sharded solve cuts its program at the collectives on a
`gloo` mesh (one piece a part, the collectives as eager pieces between
them) and keeps them inside one piece on `nccl`. On 1 x 2 and 2 x 1 meshes
of `gloo` ranks, toy_biped's walk as tests/test_torch_sharded_sqp.py's (N =
14, B = 4, 2 SQP iterations, f64), with every residual shifted by 0.05 sin(t)
(`TimedPortOcp`), over two calls (t0 = 0, then t0 = 0.35 from other x0s,
warm-started), so that a time baked into a graph would show:

- the runner with capture off, both cuts, equals the eager twin bit for bit;
- the runner with the capture emulated (tests/_graphs_common.py: the
  warm-up runs the first iteration eagerly, the capture records the pieces
  without running them, the replays run them) equals it bit for bit too:
  what a rank reads after its first call came through a static buffer;
- each graphed call runs the design's collectives on every rank (6 gathers
  and 5 reductions an iteration, 2 gathers at the end), however its pieces
  were cut and run.

The graphed runner against JAX's `make_sharded_sqp_solver` is in
tests/test_torch_sharded_sqp.py (in its spawn, beside the eager one)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests._graphs_common import TimedPortOcp, run_cases_emulated
from tests.test_torch_common import SHARDED_B, SHARDED_ITERS, SHARDED_N, SHARDED_TIMEOUT_S
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks

torch.set_num_threads(1)

CASE = dict(robot="toy_biped", n_nodes=SHARDED_N, batch=SHARDED_B, backend="gloo", device="cpu",
            dtype="float64", iterations=SHARDED_ITERS, ocp_cls=TimedPortOcp)
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
CUTS = {"split": True, "merged": False}
FIELDS = ("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size")
PARTS = 9 + 2   # the iteration's parts and the final gathers'
COLLECTIVES = {"all_gather": 6 * SHARDED_ITERS + 2, "all_reduce": 5 * SHARDED_ITERS}


@pytest.fixture(scope="module")
def capture_off():
    """{(mesh, cut): each rank's `sharded_graphs_case`}, capture off: one spawn."""
    keys = [(m, c) for m in MESHES for c in CUTS]
    cases = [(dryrun.sharded_graphs_case, dict(CASE, n_dp=MESHES[m][0], n_h=MESHES[m][1],
                                               capture=False, split=CUTS[c])) for m, c in keys]
    ranks = run_ranks(dryrun.run_cases, 2, "gloo", "cpu", cases, timeout_s=SHARDED_TIMEOUT_S)
    return {k: [r[i] for r in ranks] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def emulated():
    """{mesh: each rank's `sharded_graphs_case`}, the capture emulated: one spawn."""
    cases = [(dryrun.sharded_graphs_case, dict(CASE, n_dp=n_dp, n_h=n_h))
             for n_dp, n_h in MESHES.values()]
    ranks = run_ranks(run_cases_emulated, 2, "gloo", "cpu", cases, timeout_s=SHARDED_TIMEOUT_S)
    return {m: [r[i] for r in ranks] for i, m in enumerate(MESHES)}


def _check_equal(runs, what):
    for r in runs:
        for call, (got, ref) in enumerate(zip(r["graphed"], r["eager"])):
            for name in FIELDS:
                a, b = got[name], ref[name]
                assert a.dtype == b.dtype and np.array_equal(a, b), (
                    f"{what} rank {r['coords']} call {call} {name}: graphed and eager differ "
                    f"({float(np.nanmax(np.abs(a - b))):.3e})")
            assert np.isfinite(got["xs"]).all() and np.isfinite(got["cost"]).all()
        assert r["collectives"] == [COLLECTIVES, COLLECTIVES], (what, r["collectives"])
    first = runs[0]["graphed"]
    assert first[0]["xs"].shape == (SHARDED_B, SHARDED_N + 1, first[0]["xs"].shape[-1])
    assert not np.array_equal(first[0]["xs"], first[1]["xs"])
    for r in runs[1:]:   # the whole solution on every rank
        for call in range(2):
            np.testing.assert_array_equal(r["graphed"][call]["xs"], first[call]["xs"])


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_runner_equals_eager(capture_off, mesh, cut):
    runs = capture_off[(mesh, cut)]
    _check_equal(runs, f"{mesh} {cut}, capture off")
    for r in runs:
        report = r["report"]
        assert report["graphs"] == 0 and report["pool_bytes"] == 0
        assert sum(report["segments"].values()) == (PARTS if CUTS[cut] else 2)
        assert report["eager_collectives"] == (11 + 2 if CUTS[cut] else 0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_emulated_capture_equals_eager(emulated, mesh):
    """The `gloo` cut: one graph a part (9 an iteration, 2 for the gathers),
    the 13 collectives between them."""
    runs = emulated[mesh]
    _check_equal(runs, f"{mesh}, capture emulated")
    for r in runs:
        assert r["report"]["graphs"] == PARTS and r["report"]["eager_collectives"] == 11 + 2
