"""PyTorch port, the rank mesh (`parallel/multihost.py`,
`parallel/collectives.py`).

The layout cases of tests/test_multihost.py as tests of the pure layout
function and of `mesh_report` (two hosts of four ranks emulated by
`ranks_per_host`), then one spawn of four `gloo` ranks on the CPU laid out as
two hosts of two: JAX's psum-over-h-then-pmean-over-dp test, plus the
gather and the shift-by-one along h and the max over dp, each rank against
numpy; and one spawn of three ranks with a mesh over two of them (JAX's
`devices` argument). A rank that fails stops the others and fails the
caller."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.multihost import (
    MpcMesh,
    initialize_multihost,
    mesh_layout,
    mesh_report,
    run_ranks,
)

TIMEOUT_S = 120.0


def _mesh(n_dp: int, n_h: int, ranks_per_host: int) -> MpcMesh:
    """An MpcMesh of the layout alone (no process group)."""
    return MpcMesh(grid=np.arange(n_dp * n_h).reshape(n_dp, n_h), coords=None, groups={},
                   backend="gloo", device=torch.device("cpu"), ranks_per_host=ranks_per_host)


def test_mesh_layout_emulated_two_hosts():
    assert mesh_layout(8, None, None, 4) == (2, 4)
    mesh = _mesh(2, 4, 4)
    # each h-row is one contiguous host-major block of ranks (one host)
    for r, row in enumerate(mesh.grid):
        assert list(row) == list(range(r * 4, (r + 1) * 4))
    rep = mesh_report(mesh)
    assert rep == {"axes": {"dp": 2, "h": 4}, "n_devices": 8, "n_hosts": 2,
                   "h_axis_hosts_per_row": [1, 1], "h_axis_within_host": True}


def test_mesh_rejects_a_horizon_axis_across_hosts():
    with pytest.raises(ValueError, match="cross hosts"):
        mesh_layout(8, 2, 4, 2)


def test_mesh_single_host_default():
    assert mesh_layout(8, None, None, 8) == (1, 8)
    assert mesh_report(_mesh(1, 8, 8))["h_axis_within_host"]


def test_mesh_layout_errors_and_a_row_across_hosts():
    with pytest.raises(ValueError, match="mesh 3x4 != 8 ranks"):
        mesh_layout(8, 3, 4, 8)
    # one row may span hosts when there is no dp axis, and the report says so
    assert mesh_layout(8, 1, 8, 4) == (1, 8)
    rep = mesh_report(_mesh(1, 8, 4))
    assert rep["h_axis_hosts_per_row"] == [2] and not rep["h_axis_within_host"]


def test_initialize_multihost_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_multihost(backend="gloo")
    assert not dist.is_initialized()


def test_collectives_ride_the_mesh():
    x = np.arange(2 * 2 * 3, dtype=np.float64).reshape(2, 2, 3)
    got = run_ranks(dryrun.run_cases, 4, "gloo", "cpu",
                    [(dryrun.collectives_case, dict(x=x, n_dp=2, n_h=2, ranks_per_host=2,
                                                    backend="gloo", device="cpu"))],
                    timeout_s=TIMEOUT_S)
    expect = x.sum(axis=1).mean(axis=0)
    for rank, (out,) in enumerate(got):
        i, j = divmod(rank, 2)
        assert out["coords"] == (i, j)
        assert out["axis_index"] == (i, j) and out["axis_size"] == (2, 2)
        assert out["report"] == {"axes": {"dp": 2, "h": 2}, "n_devices": 4, "n_hosts": 2,
                                 "h_axis_hosts_per_row": [1, 1], "h_axis_within_host": True}
        np.testing.assert_allclose(out["dp_mean_of_h_sum"], expect, rtol=1e-12)
        np.testing.assert_array_equal(out["h_gather"], x[i])
        np.testing.assert_array_equal(out["h_next"], x[i, (j + 1) % 2])
        np.testing.assert_array_equal(out["dp_max"], x[:, j].max(axis=0))


def test_a_mesh_over_some_of_the_ranks():
    """`make_mpc_mesh(ranks=[0, 1])` on three ranks: ranks 0 and 1 form the
    1 x 2 mesh and sum over it; rank 2 creates the groups too, and is left
    out (coordinates None, no group)."""
    x = np.arange(2 * 3, dtype=np.float64).reshape(2, 3)
    got = run_ranks(dryrun.run_cases, 3, "gloo", "cpu",
                    [(dryrun.submesh_case, dict(ranks=[0, 1], x=x, backend="gloo",
                                                device="cpu"))], timeout_s=TIMEOUT_S)
    for rank, (out,) in enumerate(got):
        assert out["report"]["axes"] == {"dp": 1, "h": 2} and out["report"]["n_devices"] == 2
        if rank < 2:
            assert out["coords"] == (0, rank) and out["groups"] == ["dp", "h"]
            np.testing.assert_array_equal(out["h_sum"], x.sum(axis=0))
        else:
            assert out["coords"] is None and out["groups"] == [] and "h_sum" not in out


def test_a_failing_rank_fails_the_caller():
    """A mesh that does not fit the ranks raises on every rank; the caller
    gets the rank's traceback, not a hang."""
    with pytest.raises(RuntimeError, match="mesh 3x2 != 2 ranks"):
        run_ranks(dryrun.run_cases, 2, "gloo", "cpu",
                  [(dryrun.collectives_case, dict(x=np.zeros((3, 2)), n_dp=3, n_h=2,
                                                  ranks_per_host=2, backend="gloo",
                                                  device="cpu"))],
                  timeout_s=TIMEOUT_S)
