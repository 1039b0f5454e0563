"""PyTorch port, the associative-scan Riccati pair (`solver/priccati.py`):
`stage_leaf`, `parallel_backward_pass` and `parallel_forward_pass` against
JAX's and against the port's sequential passes, on the LQ data of
tests/test_riccati.py carried over with `convert.lq_from_numpy`.

The port's scan combines in a Hillis–Steele tree, JAX's `associative_scan`
in another, so the two agree to roundoff, not bit for bit. Tolerance as
tests/test_riccati.py:98-106: atol 1e-7 in f64. The parallel pass damps Quu
where the sequential one damps Quu + B'PB, so the two solve the same QP only
undamped (as tests/test_riccati.py compares them); the solver folds its
trust-region damping into the stage data first (`levenberg_damp`).

`_combine` on its own: on an exactly singular I + C_i J_j it gives JAX's
inf/NaN in JAX's places instead of raising, and JAX's values elsewhere to
1e-12 in f64."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_riccati import random_lq
from tests.test_torch_common import assert_close, to_numpy
from wb_humanoid_mpc_tpu.solver.priccati import _combine as jax_combine
from wb_humanoid_mpc_tpu.solver.priccati import _Elem as JaxElem
from wb_humanoid_mpc_tpu.solver.priccati import parallel_backward_pass as jax_pbwd
from wb_humanoid_mpc_tpu.solver.priccati import parallel_forward_pass as jax_pfwd
from wb_humanoid_mpc_tpu.solver.priccati import stage_leaf as jax_stage_leaf
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.solver.priccati import (
    _combine,
    _Elem,
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


COMBINE_TOL = dict(rtol=0.0, atol=1e-12)


def _elements(rng, batch, n=5):
    """(e_j, e_i) as numpy dicts: random A, b, eta and PSD, well-conditioned
    C and J, as the scan's leaves have."""
    def one():
        W, V = rng.standard_normal((2, batch, n, n))
        return dict(A=rng.standard_normal((batch, n, n)), b=rng.standard_normal((batch, n)),
                    C=0.1 * W @ np.swapaxes(W, -1, -2), J=0.1 * V @ np.swapaxes(V, -1, -2),
                    eta=rng.standard_normal((batch, n)))
    return one(), one()


def _combine_both(ej, ei):
    ref = jax_combine(JaxElem(**{k: jnp.asarray(v) for k, v in ej.items()}),
                      JaxElem(**{k: jnp.asarray(v) for k, v in ei.items()}))
    got = _combine(_Elem(**{k: torch.as_tensor(v) for k, v in ej.items()}),
                   _Elem(**{k: torch.as_tensor(v) for k, v in ei.items()}))
    return [t.numpy() for t in got], [np.asarray(r) for r in ref]


def test_combine_singular_gives_jax_non_finite_pattern():
    """Element 0: C_i = I, J_j = -I, so I + C_i J_j = 0; element 1: J_j =
    -diag(1, 0, ...), one zero pivot; element 2: well conditioned. No raise;
    the non-finite entries sit where JAX's do (NaN where JAX has NaN), the
    finite ones agree to 1e-12."""
    ej, ei = _elements(np.random.default_rng(0), 3)
    n = ei["C"].shape[-1]
    ei["C"][0], ej["J"][0] = np.eye(n), -np.eye(n)
    ei["C"][1], ej["J"][1] = np.eye(n), -np.diag([1.0] + [0.0] * (n - 1))
    got, ref = _combine_both(ej, ei)
    for name, a, b in zip(_Elem._fields, got, ref):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=name)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        assert not np.isfinite(b[:2]).all(), name
        assert np.isfinite(b[2]).all(), name
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], **COMBINE_TOL, err_msg=name)


def test_combine_random_batch_matches_jax():
    got, ref = _combine_both(*_elements(np.random.default_rng(1), 8))
    assert_close(got, ref, **COMBINE_TOL, what="port vs JAX _combine")
