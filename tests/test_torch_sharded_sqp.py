"""PyTorch port, the 2-D (batch x horizon) sharded SQP on a 1 x 2 mesh of
`gloo` ranks on the CPU, and the data-parallel batched solve on 2 x 1.

toy_biped, the walking schedule of `dryrun_multichip` at N = 14 (two swing
phases; 15 elements over 2 ranks pad the last block), B = 4 instances from
x0 + 0.003 N(0, 1), 2 SQP iterations, f64:

- `make_sharded_sqp_solver` on every rank against JAX's
  `make_sharded_sqp_solver` on a 1 x 2 mesh of virtual CPU devices within
  1e-8 max(1, max|ref|), the same steps, and against the port's
  `make_batched_solver` at JAX's tolerance (tests/test_sharded_sqp.py);
- its graphed runner (`GraphedShardedSolve`, capture off: the pieces and
  static buffers of the CUDA graphs, run eagerly) against the same JAX
  solve, in the same spawn (tests/test_torch_graphed_sharded.py holds it
  against the eager twin bit for bit);
- `shard_batched_solver` at 2 dp-ranks against JAX's `shard_batched_solver`
  on a mesh of 2 virtual CPU devices within 1e-8 max(1, max|ref|), the same
  steps, and against the port's `make_batched_solver`;
- the mesh point of `batched_throughput`: `devices` counts the ranks.

The 2 x 2 mesh is tests/test_torch_sharded_sqp_2x2.py (a file of its own so
that the two JAX compiles, ~100 s each, run on two workers). All cases of
one world size run in one spawn (`run_ranks`), which fails rather than
hangs when a rank dies."""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_common import (
    SHARDED_B,
    SHARDED_ITERS,
    SHARDED_N,
    SHARDED_TIMEOUT_S,
    SHARDED_TOL,
    assert_fields_close,
    check_sharded_runs,
    jax_shard_batched,
    jax_sharded,
    port_batched_walk,
    port_problem,
    sharded_case,
)
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks
from wb_humanoid_mpc_tpu_torch.solver.sharded_sqp import make_sharded_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world2():
    """Each rank's (sharded 1x2, shard_batched 2x1, throughput 2x1, graphed
    sharded 1x2) results."""
    case = sharded_case(1, 2)
    return run_ranks(dryrun.run_cases, 2, "gloo", "cpu", [
        (dryrun.sharded_sqp_case, case),
        (dryrun.shard_batched_case, dict(robot="toy_biped", n_nodes=SHARDED_N, batch=SHARDED_B,
                                         n_dp=2, backend="gloo", device="cpu",
                                         dtype="float64", iterations=SHARDED_ITERS)),
        (dryrun.throughput_case, dict(batch=2, n_nodes=3, n_dp=2, backend="gloo",
                                      device="cpu")),
        (dryrun.sharded_graphs_case, dict({k: case[k] for k in GRAPHS_CASE_KEYS},
                                          capture=False))], timeout_s=SHARDED_TIMEOUT_S)


GRAPHS_CASE_KEYS = ("robot", "n_nodes", "batch", "n_dp", "n_h", "backend", "device", "dtype",
                    "iterations")


@pytest.fixture(scope="module")
def batched():
    return port_batched_walk()


@pytest.fixture(scope="module")
def jax_1x2():
    return jax_sharded(1, 2)


def test_sharded_1x2_matches_jax_and_the_batched_solve(world2, batched, jax_1x2):
    check_sharded_runs([r[0] for r in world2], 1, 2, jax_1x2, batched)


def test_graphed_sharded_1x2_matches_jax(world2, jax_1x2):
    """The graphed runner's first call (t0 = 0, the walk's x0s) on every rank."""
    for r in world2:
        assert_fields_close(r[3]["graphed"][0], jax_1x2,
                            ("xs", "us", "lam", "cost", "g_norm", "defect_norm"), SHARDED_TOL,
                            f"graphed sharded solve rank {r[3]['coords']} vs JAX's")


def test_shard_batched_matches_jax(world2):
    ref = jax_shard_batched(2)
    for rank, r in enumerate(world2):
        assert_fields_close(r[1], ref, ("xs", "us", "lam", "cost", "g_norm", "defect_norm"),
                            SHARDED_TOL, f"shard_batched_solver rank {rank} vs JAX's")


def test_shard_batched_matches_batched(world2, batched):
    for rank, r in enumerate(world2):
        assert_fields_close(r[1], batched, ("xs", "us", "lam", "cost", "g_norm", "defect_norm"),
                            SHARDED_TOL, f"shard_batched_solver rank {rank}")


def test_throughput_counts_the_mesh(world2):
    for r in world2:
        out = r[2]
        assert out["devices"] == 2 and out["batch"] == 2 and out["finite"]


def test_sharded_solver_refuses_what_jax_refuses():
    pb = port_problem("walk", 4, "f64")
    al = SqpSolverConfig(n_nodes=4, dt=pb.cfg.sqp.dt, equality_handling="al")
    with pytest.raises(ValueError, match="projection path only"):
        make_sharded_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, al, None, device="cpu")
