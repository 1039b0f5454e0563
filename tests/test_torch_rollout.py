"""PyTorch port, K3 (the forward rollout, `ops/rollout.py`): its plain version
(the ported `forward_pass`) against the Pallas kernel run in interpret mode
and against JAX's `forward_pass`, on the stage data of
tests/test_ops_rollout.py (`random_stage_data` is the port's numpy copy of
`_stage_data`); and the split LQ solve (`backward_pass`, whose solution now
carries P and p, then `forward_rollout`) against JAX's.

Tolerances as tests/test_ops_rollout.py: f32 atol 1e-5 x max(1, max|dxs|),
f64 rtol = atol = 1e-12; the split solve in f64 at rtol 1e-9. The CUDA
kernel is held against this plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_riccati import random_lq
from tests.test_torch_common import DTYPES, assert_close, jax_mode, to_numpy
from wb_humanoid_mpc_tpu.ops.rollout import forward_rollout as jax_forward_rollout
from wb_humanoid_mpc_tpu.ops.rollout import pallas_forward_rollout
from wb_humanoid_mpc_tpu.solver.riccati import backward_pass as jax_backward_pass
from wb_humanoid_mpc_tpu.solver.riccati import forward_pass as jax_forward_pass
from wb_humanoid_mpc_tpu_torch import convert
from wb_humanoid_mpc_tpu_torch.ops import rollout
from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass, forward_pass

FIELDS = ("A", "B", "d", "K", "k", "dx0")


def _jax_refs(data, dtype):
    """(Pallas interpret, JAX forward_pass) results as numpy (dxs, dus)."""
    jdt = DTYPES[dtype][0]
    with jax_mode(dtype):
        A, B, d, K, k, dx0 = (jnp.asarray(data[f], dtype=jdt) for f in FIELDS)
        pallas = to_numpy(pallas_forward_rollout(A, B, d, K, k, dx0, interpret=True))
        scan = to_numpy(jax_forward_pass(types.SimpleNamespace(A=A, B=B, d=d),
                                         types.SimpleNamespace(K=K, k=k), dx0))
    return pallas, scan


def _port(data, dtype):
    return rollout.forward_rollout_plain(*(torch.as_tensor(data[f], dtype=DTYPES[dtype][1])
                                           for f in FIELDS))


def _tol(dtype, ref):
    if dtype == "f64":
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=0.0, atol=1e-5 * max(1.0, float(np.abs(ref[0]).max())))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", [(28, 58, 35), (15, 35, 35), (7, 12, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_and_scan(shape, dtype):
    np_dt = np.float32 if dtype == "f32" else np.float64
    data = rollout.random_stage_data(np.random.default_rng(0), *shape, dtype=np_dt)
    pallas, scan = _jax_refs(data, dtype)
    got = _port(data, dtype)
    assert got[0].shape == (shape[0] + 1, shape[1]) and got[1].shape == shape[::2]
    assert_close(got, pallas, **_tol(dtype, pallas), what=f"{shape} vs Pallas interpret")
    assert_close(got, scan, **_tol(dtype, scan), what=f"{shape} vs JAX forward_pass")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_of_instances(dtype):
    """A leading batch of two problems (the kernel's grid) against JAX's vmap
    of the Pallas kernel and against each element alone."""
    parts = [rollout.random_stage_data(np.random.default_rng(s), 10, 20, 8, dtype=np.float64)
             for s in (1, 2)]
    data = {f: np.stack([p[f] for p in parts]) for f in FIELDS}
    jdt = DTYPES[dtype][0]
    with jax_mode(dtype):
        ref = to_numpy(jax.vmap(lambda *a: pallas_forward_rollout(*a, interpret=True))(
            *(jnp.asarray(data[f], dtype=jdt) for f in FIELDS)))
    got = _port(data, dtype)
    assert got[0].shape == (2, 11, 20) and got[1].shape == (2, 10, 8)
    assert_close(got, ref, **_tol(dtype, ref), what="batch vs vmapped Pallas")
    for i, part in enumerate(parts):
        one = _port(part, dtype)
        assert_close([got[0][i], got[1][i]], one, rtol=0.0,
                     atol=1e-14 if dtype == "f64" else 1e-6, what=f"batch element {i}")


def test_dispatch_on_cpu_is_plain():
    """backend='auto' (and JAX's 'scan') on CPU tensors runs `forward_pass`,
    bit for bit, and never counts a kernel launch; JAX's 'interpret' has no
    counterpart and raises."""
    data = rollout.random_stage_data(np.random.default_rng(3), 6, 10, 4, dtype=np.float64)
    t = {f: torch.as_tensor(v) for f, v in data.items()}
    lq, sol = types.SimpleNamespace(A=t["A"], B=t["B"], d=t["d"]), types.SimpleNamespace(
        K=t["K"], k=t["k"])
    before = rollout.LAUNCHES
    ref = forward_pass(lq, sol, t["dx0"])
    for backend in ("auto", "scan", "plain"):
        got = rollout.forward_rollout(lq, sol, t["dx0"], backend=backend)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), backend
    assert rollout.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown rollout backend"):
        rollout.forward_rollout(lq, sol, t["dx0"], backend="interpret")


@pytest.mark.parametrize("seed", [0, 3])
def test_split_solve_matches_jax(seed):
    """JAX's backward_pass + forward_rollout against the port's, on JAX's own
    stage data carried over with `convert.lq_from_numpy`: K, k, P, p, dxs,
    dus; and JAX's gains (`convert.riccati_solution_from_numpy`) rolled out
    by the port."""
    rng = np.random.default_rng(seed)
    jlq = random_lq(rng, N=17)
    jdx0 = jnp.asarray(rng.standard_normal(6) * 0.5)
    jsol = jax_backward_pass(jlq, reg=1e-8)
    ref = to_numpy(list(jsol) + list(jax_forward_rollout(jlq, jsol, jdx0, backend="scan")))
    lq = convert.lq_from_numpy(jlq, device="cpu", dtype=torch.float64)
    dx0 = torch.as_tensor(np.asarray(jdx0))
    sol = backward_pass(lq, 1e-8)
    assert sol.P.shape == (18, 6, 6) and sol.p.shape == (18, 6)
    got = list(sol) + list(rollout.forward_rollout(lq, sol, dx0))
    assert_close(got, ref, rtol=1e-9, atol=1e-10, what="split solve")
    carried = convert.riccati_solution_from_numpy(jsol, device="cpu", dtype=torch.float64)
    assert_close(rollout.forward_rollout(lq, carried, dx0), ref[4:], rtol=1e-12, atol=1e-12,
                 what="JAX gains rolled out by the port")
