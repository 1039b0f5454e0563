"""PyTorch port, the horizon-sharded Riccati (`parallel/horizon.py`) on
`gloo` ranks on the CPU, f64.

Random LQ problems (nx 10, nu 4, the recipe of tests/test_horizon_sharded.py)
at (N, ranks) = (15, 4), (8, 2) and (28, 4): the two with (N + 1) % ranks
!= 0 pad the last block with identity elements. Each rank gets the whole
problem and returns the whole (dxs, dus); every rank's answer is held
against JAX's `horizon_sharded_lq_solve` on the same number of virtual CPU
devices and against the port's sequential `backward_pass` + `forward_pass`,
at JAX's own tolerance (rtol 1e-8, atol 1e-9). The ranks of one world size
share one spawn (`run_ranks`), with a timeout so that a rank that dies
fails the test instead of hanging it."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from wb_humanoid_mpc_tpu.parallel.horizon import horizon_sharded_lq_solve as jax_solve
from wb_humanoid_mpc_tpu.solver.transcription import LQApprox as JaxLQ
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks
from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass, forward_pass
from wb_humanoid_mpc_tpu_torch.solver.transcription import LQApprox

CASES = [(15, 4), (8, 2), (28, 4)]
NX, NU, REG = 10, 4, 1e-9
TOL = dict(rtol=1e-8, atol=1e-9)
TIMEOUT_S = 240.0


def random_lq(N: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def spd(n, scale=1.0):
        a = rng.normal(size=(N, n, n)) * 0.3
        return scale * (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(n))

    lq = dict(A=np.eye(NX) + 0.05 * rng.normal(size=(N, NX, NX)),
              B=0.1 * rng.normal(size=(N, NX, NU)), d=0.01 * rng.normal(size=(N, NX)),
              Qxx=spd(NX), Quu=spd(NU, 0.5), Qux=0.05 * rng.normal(size=(N, NU, NX)),
              qx=rng.normal(size=(N, NX)), qu=rng.normal(size=(N, NU)))
    lq.update(QN=spd(NX)[0], qN=rng.normal(size=NX))
    return lq


def dx0() -> np.ndarray:
    return np.random.default_rng(1).normal(size=NX) * 0.1


@pytest.fixture(scope="module")
def port_runs():
    """{(N, ranks): [(dxs, dus) of each rank]}: one spawn per world size."""
    out = {}
    for world in sorted({h for _, h in CASES}):
        cases = [c for c in CASES if c[1] == world]
        got = run_ranks(dryrun.run_cases, world, "gloo", "cpu",
                        [(dryrun.horizon_case, dict(lq=random_lq(N, N), dx0=dx0(), n_h=H, reg=REG,
                                                    backend="gloo", device="cpu"))
                         for N, H in cases], timeout_s=TIMEOUT_S)
        for k, case in enumerate(cases):
            out[case] = [rank[k] for rank in got]
    return out


def _check(port_runs, case, ref):
    for rank, (dxs, dus) in enumerate(port_runs[case]):
        assert dxs.shape == (case[0] + 1, NX) and dus.shape == (case[0], NU)
        for name, a, b in (("dxs", dxs, ref[0]), ("dus", dus, ref[1])):
            np.testing.assert_allclose(a, b, **TOL, err_msg=f"{case} rank {rank} {name}")


@pytest.mark.parametrize("case", CASES, ids=[f"N{n}_h{h}" for n, h in CASES])
def test_horizon_sharded_matches_jax(port_runs, case):
    N, H = case
    lq = JaxLQ(**{k: jnp.asarray(v) for k, v in random_lq(N, N).items()},
               cost=jnp.zeros(()), g_norm=jnp.zeros(()), defect_norm=jnp.zeros(()))
    mesh = Mesh(np.array(jax.devices()[:H]), ("h",))
    ref = jax.jit(lambda lq_, dx0_: jax_solve(lq_, dx0_, mesh, "h", REG))(lq, jnp.asarray(dx0()))
    _check(port_runs, case, [np.asarray(r) for r in ref])


@pytest.mark.parametrize("case", CASES, ids=[f"N{n}_h{h}" for n, h in CASES])
def test_horizon_sharded_matches_sequential(port_runs, case):
    lq = LQApprox(**{k: torch.as_tensor(v) for k, v in random_lq(case[0], case[0]).items()})
    dxs, dus = forward_pass(lq, backward_pass(lq, REG), torch.as_tensor(dx0()))
    _check(port_runs, case, [dxs.numpy(), dus.numpy()])
