"""PyTorch port, the 2-D sharded SQP on a 2 x 2 mesh of `gloo` ranks on the
CPU: the case of tests/test_torch_sharded_sqp.py (toy_biped walk, N = 14,
B = 4, 2 SQP iterations, f64) with the batch split over dp as well, against
JAX's `make_sharded_sqp_solver` on a 2 x 2 mesh of virtual CPU devices
(1e-8 max(1, max|ref|), the same steps) and against the port's
`make_batched_solver` at JAX's tolerance."""

from __future__ import annotations

import torch

from tests.test_torch_common import (
    SHARDED_TIMEOUT_S,
    check_sharded_runs,
    jax_sharded,
    port_batched_walk,
    sharded_case,
)
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks

torch.set_num_threads(1)


def test_sharded_2x2_matches_jax_and_the_batched_solve():
    runs = run_ranks(dryrun.run_cases, 4, "gloo", "cpu",
                     [(dryrun.sharded_sqp_case, sharded_case(2, 2))],
                     timeout_s=SHARDED_TIMEOUT_S)
    check_sharded_runs([r[0] for r in runs], 2, 2, jax_sharded(2, 2), port_batched_walk())
