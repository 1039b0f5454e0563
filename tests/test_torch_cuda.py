"""PyTorch port, card tier: each CUDA kernel against its plain PyTorch version
on the card, in float32 and float64, at the main path's shapes and at the
edges of the kernels' launch geometry (a second block and a ragged tail for
K2; the shared-memory opt-in above 48 KB and the refusal above 227 KB for
K1, and K1 on the AL path's unprojected LQ from real solver data; for K3
more rows than warps and a batch). Needs an NVIDIA card and `nvcc`; skipped
elsewhere. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 as tests/test_ops_fkvel.py's Mosaic tier (f32 rtol 1e-4,
atol 5e-6), K1 as tests/test_ops_riccati.py's (f32 rtol 1e-3, atol 5e-4);
K3 as tests/test_ops_rollout.py's (f32 1e-5, f64 1e-12, times max(1,
max|ref|)); otherwise float64 at 1e-9 relative to each output's largest entry."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem, load_wb_model
from wb_humanoid_mpc_tpu_torch.ops import fkvel, riccati, rollout
from wb_humanoid_mpc_tpu_torch.solver.riccati import levenberg_damp
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig
from wb_humanoid_mpc_tpu_torch.solver.transcription import make_lq_functions

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-3, atol=5e-4), torch.float64: dict(rtol=1e-9, atol=1e-9)}
FK_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-6), torch.float64: dict(rtol=1e-9, atol=1e-9)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with the command in the docstring)")
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _close(got, ref, tol, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        torch.cuda.synchronize()
        scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
        torch.testing.assert_close(a, b, rtol=tol["rtol"], atol=tol["atol"] * scale,
                                   msg=lambda m: f"{what} output {i}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("robot", ["humanoid23", "toy_biped"])
@pytest.mark.parametrize("B", [1, 28, 130])
def test_fkvel_kernel_matches_plain(card, robot, dtype, B):
    r = load_wb_model(ASSETS / robot)[1].robot
    rng = np.random.default_rng(B)
    q = torch.as_tensor(rng.normal(size=(B, r.nq)) * 0.3, dtype=dtype, device=card)
    v = torch.as_tensor(rng.normal(size=(B, r.nq)) * 0.5, dtype=dtype, device=card)
    before = fkvel.LAUNCHES
    fk_k, vb_k = fkvel.fkvel_batch(r, q, v)           # "auto" on CUDA tensors: the kernel
    assert fkvel.LAUNCHES == before + 1
    fk_p, vb_p = fkvel.fkvel_plain(r, q, v)
    _close(list(fk_k) + list(vb_k), list(fk_p) + list(vb_p), FK_TOL[dtype], f"K2 {robot} B={B}")


def _lq(seed, N, nx, nu, dtype, card, batch=None, quu_span=1.0):
    rng = np.random.default_rng(seed)
    parts = [riccati.random_lq_data(rng, N, nx, nu, dtype=np.float64, quu_span=quu_span)
             for _ in range(batch or 1)]
    data = {k: np.stack([p[k] for p in parts]) if batch else parts[0][k] for k in parts[0]}
    return [torch.as_tensor(data[k], dtype=dtype, device=card)
            for k in ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(28, 58, 21), (28, 58, 35), (7, 12, 5), (6, 36, 10)],
                         ids=lambda s: "x".join(map(str, s)))
def test_riccati_kernel_matches_plain(card, shape, dtype):
    """(28, 58, 35) in f32 and (28, 58, 21) in f64 need the opt-in above 48 KB."""
    args = _lq(sum(shape), *shape, dtype, card)
    before = riccati.LAUNCHES
    got = riccati.riccati_rollout_cuda(*args, reg=1e-8)
    assert riccati.LAUNCHES == before + 1
    _close(got, riccati.riccati_rollout_plain(*args, reg=1e-8), TOL[dtype], f"K1 {shape}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_riccati_kernel_batch(card, dtype):
    args = _lq(3, 28, 58, 21, dtype, card, batch=3)
    got = riccati.riccati_rollout_cuda(*args, reg=1e-8)
    assert got[0].shape == (3, 28, 21, 58) and got[2].shape == (3, 29, 58)
    _close(got, riccati.riccati_rollout_plain(*args, reg=1e-8), TOL[dtype], "K1 batch")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_riccati_kernel_regularization_branch(card, dtype):
    """Quu diagonals spanning four orders of magnitude at the shape of
    tests/test_ops_riccati.py's case (larger shapes with this spread make
    the random stage costs non-convex, and then neither solve is defined)."""
    args = _lq(2, 8, 14, 6, dtype, card, batch=2, quu_span=100.0)
    got = riccati.riccati_rollout_cuda(*args, reg=1e-6)
    _close(got, riccati.riccati_rollout_plain(*args, reg=1e-6), TOL[dtype], "K1 reg branch")


def test_riccati_kernel_refuses_shapes_beyond_shared_memory(card):
    args = _lq(0, 2, 120, 60, torch.float64, card)
    with pytest.raises(ValueError, match="shared memory"):
        riccati.riccati_rollout_cuda(*args)


K3_TOL = {torch.float32: dict(rtol=0.0, atol=1e-5), torch.float64: dict(rtol=0.0, atol=1e-12)}


def _stages(seed, N, nx, nu, dtype, card, batch=None):
    rng = np.random.default_rng(seed)
    parts = [rollout.random_stage_data(rng, N, nx, nu, dtype=np.float64)
             for _ in range(batch or 1)]
    return [torch.as_tensor(np.stack([p[k] for p in parts]) if batch else parts[0][k],
                            dtype=dtype, device=card)
            for k in ("A", "B", "d", "K", "k", "dx0")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(28, 58, 35), (28, 58, 21), (15, 35, 35), (7, 12, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rollout_kernel_matches_plain(card, shape, dtype):
    """nx 58 is more rows than the block's 32 warps: a warp takes two."""
    args = _stages(sum(shape), *shape, dtype, card)
    before = rollout.LAUNCHES
    got = rollout.forward_rollout_cuda(*args)
    assert rollout.LAUNCHES == before + 1
    assert got[0].shape == (shape[0] + 1, shape[1]) and got[1].shape == (shape[0], shape[2])
    _close(got, rollout.forward_rollout_plain(*args), K3_TOL[dtype], f"K3 {shape}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rollout_kernel_batch(card, dtype):
    args = _stages(4, 28, 58, 35, dtype, card, batch=3)
    got = rollout.forward_rollout_cuda(*args)
    assert got[0].shape == (3, 29, 58) and got[1].shape == (3, 28, 35)
    _close(got, rollout.forward_rollout_plain(*args), K3_TOL[dtype], "K3 batch")


def test_riccati_kernel_on_the_al_path_lq(card):
    """K1 at (28, 58, 35) on the AL path's unprojected, damped LQ of the
    humanoid23 stance problem (rho 1e3, f32), against the plain version."""
    pb = build_wb_problem(ASSETS / "humanoid23", 28, device=card, dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=28, dt=pb.cfg.sqp.dt)
    fns = make_lq_functions(pb.ocp, pb.model.flow_map, cfg.dt, 28, pb.bp, sensitivity="node",
                            flow_batch=pb.model.flow_map_batch)
    times = cfg.dt * torch.arange(29, dtype=torch.float32, device=card)
    lq = levenberg_damp(fns.lq_approximation(pb.traj, times, pb.params, pb.lam, cfg.rho), cfg.reg)
    assert lq.B.shape == (28, 58, 35)
    args = (lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx, lq.qu, lq.QN, lq.qN,
            torch.zeros(58, dtype=torch.float32, device=card))
    got = riccati.riccati_rollout_cuda(*args, reg=cfg.reg_num)
    _close(got, riccati.riccati_rollout_plain(*args, reg=cfg.reg_num), TOL[torch.float32],
           "K1 AL path")
