"""PyTorch port, the associative-scan Riccati pair (`solver/priccati.py`):
`stage_leaf`, `parallel_backward_pass` and `parallel_forward_pass` against
JAX's and against the port's sequential passes, on the LQ data of
tests/test_riccati.py carried over with `convert.lq_from_numpy`.

The port's scan combines in a Hillis–Steele tree, JAX's `associative_scan`
in another, so the two agree to roundoff, not bit for bit. Tolerance as
tests/test_riccati.py:98-106: atol 1e-7 in f64. The parallel pass damps Quu
where the sequential one damps Quu + B'PB, so the two solve the same QP only
undamped (as tests/test_riccati.py compares them); the solver folds its
trust-region damping into the stage data first (`levenberg_damp`)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_riccati import random_lq
from tests.test_torch_common import assert_close, to_numpy
from wb_humanoid_mpc_tpu.solver.priccati import parallel_backward_pass as jax_pbwd
from wb_humanoid_mpc_tpu.solver.priccati import parallel_forward_pass as jax_pfwd
from wb_humanoid_mpc_tpu.solver.priccati import stage_leaf as jax_stage_leaf
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.solver.priccati import (
    parallel_backward_pass,
    parallel_forward_pass,
    stage_leaf,
)
from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass, forward_pass

TOL = dict(rtol=0.0, atol=1e-7)


def _problem(seed, N):
    rng = np.random.default_rng(seed)
    jlq = random_lq(rng, N=N)
    jdx0 = jnp.asarray(rng.standard_normal(6) * 0.5)
    return jlq, jdx0, convert.lq_from_numpy(jlq, device="cpu", dtype=torch.float64), \
        torch.as_tensor(np.asarray(jdx0))


@pytest.mark.parametrize("reg", [0.0, 1e-8])
@pytest.mark.parametrize("N", [1, 17, 28])
def test_parallel_passes_match_jax(N, reg):
    """N = 1, 17 and 28: one node, an odd horizon (a ragged last round) and
    the main path's."""
    jlq, jdx0, lq, dx0 = _problem(N, N)
    jsol = jax_pbwd(jlq, reg=reg)
    ref = to_numpy(list(jsol) + list(jax_pfwd(jlq, jsol, jdx0)))
    sol = parallel_backward_pass(lq, reg)
    got = list(sol) + list(parallel_forward_pass(lq, sol, dx0))
    assert_close(got, ref, **TOL, what="port vs JAX parallel passes")


@pytest.mark.parametrize("N", [1, 17, 28])
def test_parallel_passes_match_sequential(N):
    """Undamped, as tests/test_riccati.py compares them."""
    _, _, lq, dx0 = _problem(N, N)
    sol = parallel_backward_pass(lq, 0.0)
    seq = backward_pass(lq, 0.0)
    assert_close(sol, seq, **TOL, what="parallel vs sequential backward pass")
    assert_close(parallel_forward_pass(lq, sol, dx0), forward_pass(lq, seq, dx0), **TOL,
                 what="parallel vs sequential forward pass")


def test_stage_leaf_matches_jax():
    jlq, _, lq, _ = _problem(5, 4)
    ref = to_numpy([jax_stage_leaf(*(getattr(jlq, f)[i] for f in
                                     ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu")), 1e-6)
                    for i in range(4)])
    got = stage_leaf(lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu, 1e-6)
    ref = [np.stack([r[j] for r in ref]) for j in range(5)]
    assert_close(got, ref, rtol=1e-12, atol=1e-12, what="stage_leaf")
