"""PyTorch port, K1 (the fused Riccati + rollout, `ops/riccati.py`): its plain
version (the ported `backward_pass` + `forward_pass`, Cholesky) against the
Pallas kernel run in interpret mode and against the JAX scan pair, on the
synthetic LQ data of tests/test_ops_riccati.py (`random_lq_data` is the
port's numpy copy of `_lq_data`).

Tolerances as tests/test_ops_riccati.py: f32 atol 2e-4 (K, k; dxs and dus
scaled by max(|dxs|, 1)); f64 rtol 1e-9; the regularization branch at rtol
1e-8. The CUDA kernel is held against this plain version on the card by
chip_smoke.py."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import DTYPES, assert_close, jax_mode, to_numpy
from wb_humanoid_mpc_tpu.ops.riccati import pallas_riccati_rollout
from wb_humanoid_mpc_tpu.solver.riccati import backward_pass, forward_pass
from wb_humanoid_mpc_tpu_torch.ops import riccati

FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")


def _jax_refs(data, dtype, reg):
    """(Pallas interpret, scan pair) results as numpy (K, k, dxs, dus)."""
    jdt = DTYPES[dtype][0]
    with jax_mode(dtype):
        a = [jnp.asarray(data[f], dtype=jdt) for f in FIELDS]
        pallas = to_numpy(pallas_riccati_rollout(*a, reg=reg, interpret=True))
        lq = types.SimpleNamespace(**dict(zip(FIELDS[:-1], a[:-1])))
        sol = backward_pass(lq, reg)
        dxs, dus = forward_pass(lq, sol, a[-1])
        scan = to_numpy((sol.K, sol.k, dxs, dus))
    return pallas, scan


def _port(data, dtype, reg, backend="auto"):
    tdt = DTYPES[dtype][1]
    args = [torch.as_tensor(data[f], dtype=tdt) for f in FIELDS]
    fn = riccati.riccati_rollout_plain if backend == "plain" else None
    if fn is None:
        lq = types.SimpleNamespace(**dict(zip(FIELDS[:-1], args[:-1])))
        dxs, dus = riccati.riccati_rollout(lq, args[-1], reg, backend=backend)
        return None, None, dxs, dus
    return fn(*args, reg=reg)


def _assert_f32(got, ref, what):
    scale = max(float(np.abs(ref[2]).max()), 1.0)
    assert_close(got[:2], ref[:2], rtol=0.0, atol=2e-4, what=what)
    assert_close(got[2:], ref[2:], rtol=0.0, atol=2e-4 * scale, what=what)


@pytest.mark.parametrize("shape", [(28, 58, 11), (15, 35, 12), (7, 12, 5)])
def test_plain_matches_pallas_f32(shape):
    N, nx, nu = shape
    data = riccati.random_lq_data(np.random.default_rng(0), N, nx, nu)
    pallas, scan = _jax_refs(data, "f32", 1e-8)
    got = _port(data, "f32", 1e-8, backend="plain")
    _assert_f32(got, pallas, f"{shape} vs Pallas interpret")
    _assert_f32(got, scan, f"{shape} vs scan pair")


def test_plain_matches_pallas_f64_tight():
    data = riccati.random_lq_data(np.random.default_rng(1), 10, 20, 8, dtype=np.float64)
    pallas, scan = _jax_refs(data, "f64", 1e-8)
    got = _port(data, "f64", 1e-8, backend="plain")
    assert_close(got, scan, rtol=1e-9, atol=1e-12, what="f64 vs scan pair")
    assert_close(got, pallas, rtol=1e-9, atol=1e-10, what="f64 vs Pallas interpret")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_relative_regularization_branch(dtype):
    """Quu diagonals spanning four orders of magnitude (quu_span=100)."""
    data = riccati.random_lq_data(np.random.default_rng(2), 8, 14, 6, dtype=np.float64,
                                  quu_span=100.0)
    pallas, scan = _jax_refs(data, dtype, 1e-6)
    got = _port(data, dtype, 1e-6, backend="plain")
    if dtype == "f64":
        assert_close(got[2:], pallas[2:], rtol=1e-8, atol=1e-9, what="reg branch vs Pallas")
        assert_close(got, scan, rtol=1e-9, atol=1e-12, what="reg branch vs scan")
    else:
        _assert_f32(got, pallas, "reg branch vs Pallas")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_batch_of_instances(dtype):
    """A leading batch of two problems (the kernel's grid) against JAX's vmap."""
    parts = [riccati.random_lq_data(np.random.default_rng(s), 6, 12, 5, dtype=np.float64)
             for s in (4, 5)]
    data = {f: np.stack([p[f] for p in parts]) for f in FIELDS}
    jdt = DTYPES[dtype][0]
    with jax_mode(dtype):
        ref = to_numpy(jax.vmap(lambda *a: pallas_riccati_rollout(*a, reg=1e-8, interpret=True))(
            *(jnp.asarray(data[f], dtype=jdt) for f in FIELDS)))
    got = _port(data, dtype, 1e-8, backend="plain")
    if dtype == "f64":
        assert_close(got, ref, rtol=1e-9, atol=1e-10, what="batch")
    else:
        _assert_f32(got, ref, "batch")


def test_dispatch_on_cpu_is_plain():
    """backend='auto' on CPU tensors runs the plain version, bit for bit, and
    never counts a kernel launch."""
    data = riccati.random_lq_data(np.random.default_rng(3), 6, 10, 4, dtype=np.float64)
    before = riccati.LAUNCHES
    _, _, dxs_a, dus_a = _port(data, "f64", 1e-8, backend="auto")
    _, _, dxs_p, dus_p = _port(data, "f64", 1e-8, backend="plain")
    assert torch.equal(dxs_a, dxs_p) and torch.equal(dus_a, dus_p)
    assert riccati.LAUNCHES == before


@pytest.mark.parametrize("pass_", ["sequential", "parallel"])
def test_non_positive_definite_stage_gives_nan_as_jax(pass_):
    """A stage whose Quu is not positive definite: JAX's Cholesky returns NaN
    and the solve goes on to a non-finite cost (which the runtime's recovery
    handles); the port's backward passes give NaN in the same places instead
    of raising, and the same finite values elsewhere (f64, rtol 1e-9)."""
    from wb_humanoid_mpc_tpu.solver.priccati import parallel_backward_pass as jax_parallel
    from wb_humanoid_mpc_tpu_torch.solver import priccati as port_priccati
    from wb_humanoid_mpc_tpu_torch.solver import riccati as port_riccati

    data = riccati.random_lq_data(np.random.default_rng(11), 8, 12, 5, dtype=np.float64)
    data["Quu"][5] = -np.eye(5) * 1e3   # stage 5: negative definite
    lq_j = types.SimpleNamespace(**{f: jnp.asarray(data[f]) for f in FIELDS[:-1]})
    lq_t = types.SimpleNamespace(**{f: torch.as_tensor(data[f]) for f in FIELDS[:-1]})
    if pass_ == "sequential":
        ref, got = backward_pass(lq_j, 1e-8), port_riccati.backward_pass(lq_t, 1e-8)
    else:
        ref, got = jax_parallel(lq_j, 1e-8), port_priccati.parallel_backward_pass(lq_t, 1e-8)
    for name, a, b in zip(("K", "k", "P", "p"), to_numpy(tuple(got)), to_numpy(tuple(ref))):
        assert np.isnan(b).any(), name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=1e-9, atol=1e-9,
                                   err_msg=name)
