"""PyTorch port, K2 (the FK + velocity/bias tree pass, `ops/fkvel.py`): its
plain version against the Pallas kernel run in interpret mode and against
the JAX "xla" path, and the batched flow map built on it.

Tolerances: f32 atol 2e-6 and f64 atol 1e-12 for the tree pass
(tests/test_ops_fkvel.py:49); the flow map at rtol 2e-4, atol 2e-5 in f32
(tests/test_ops_fkvel.py:66) and 1e-10 in f64. The CUDA kernel itself is held
against this plain version on the card by tests/test_torch_cuda.py and timed
alone by the kernel harness, chip_smoke.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_common import check_pair, jax_wb, port_wb
from wb_humanoid_mpc_tpu.ops.fkvel import fkvel_batch as jax_fkvel_batch
from wb_humanoid_mpc_tpu.ops.fkvel import pallas_fkvel
from wb_humanoid_mpc_tpu_torch.ops import fkvel

FK_TOL = {"f64": dict(rtol=0.0, atol=1e-12), "f32": dict(rtol=0.0, atol=2e-6)}
FLOW_TOL = {"f64": dict(rtol=1e-10, atol=1e-10), "f32": dict(rtol=2e-4, atol=2e-5)}


def _qv(nq, B):
    def inputs(rng):
        return [rng.normal(size=(B, nq)) * 0.3, rng.normal(size=(B, nq)) * 0.5]
    return inputs


def _packed(fk, vb, stack):
    """(FK, VelBias) -> the Pallas wrapper's packed (R, p, vb, axes, E)."""
    return (fk.R, fk.p, stack([vb.v_o, vb.omega, vb.a_o, vb.domega], 2), fk.joint_axis_w,
            fk.E_base)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_plain_matches_pallas_interpret(dtype):
    jr, tr = jax_wb("toy_biped")[1].robot, port_wb("toy_biped")[1].robot
    import torch

    before = fkvel.LAUNCHES
    check_pair(0, _qv(jr.nq, 7),
               lambda q, v: pallas_fkvel(jr, q, v, interpret=True),
               lambda q, v: _packed(*fkvel.fkvel_batch(tr, q, v), torch.stack),
               dtype, what="fkvel vs Pallas interpret", **FK_TOL[dtype])
    assert fkvel.LAUNCHES == before   # CPU tensors never reach the kernel


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_plain_matches_xla_path(dtype):
    jr, tr = jax_wb("toy_biped")[1].robot, port_wb("toy_biped")[1].robot
    check_pair(1, _qv(jr.nq, 7),
               lambda q, v: jax_fkvel_batch(jr, q, v, backend="xla"),
               lambda q, v: fkvel.fkvel_batch(tr, q, v, backend="plain"),
               dtype, what="fkvel vs xla", **FK_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_flow_map_batch_matches_interpret(dtype):
    _, jm, _ = jax_wb("toy_biped")
    _, tm, _ = port_wb("toy_biped")

    def inputs(rng):
        return [np.zeros(5), rng.normal(size=(5, jm.state_dim)) * 0.2,
                rng.normal(size=(5, jm.input_dim))]

    check_pair(2, inputs,
               lambda t, x, u: jm.flow_map_batch(t, x, u, backend="interpret"),
               lambda t, x, u: tm.flow_map_batch(t, x, u),
               dtype, what="flow_map_batch", **FLOW_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_humanoid23_flow_map(dtype):
    """One full-width flow-map evaluation: both the differentiable `flow_map`
    and the batched K2 path against JAX's vmap(flow_map)."""
    _, jm, _ = jax_wb("humanoid23")
    _, tm, _ = port_wb("humanoid23")

    def inputs(rng):
        return [np.zeros(3), rng.normal(size=(3, jm.state_dim)) * 0.2,
                rng.normal(size=(3, jm.input_dim))]

    def jax_fn(t, x, u):
        out = jax.vmap(lambda t_, x_, u_: jm.flow_map(t_, x_, u_))(t, x, u)
        return out, out

    check_pair(3, inputs, jax_fn,
               lambda t, x, u: (tm.flow_map(t, x, u), tm.flow_map_batch(t, x, u)),
               dtype, what="humanoid23 flow map", **FLOW_TOL[dtype])
    assert jnp.zeros(()).dtype == jnp.float64   # the suite's x64 mode is restored
