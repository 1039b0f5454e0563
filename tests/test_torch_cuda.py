"""PyTorch port, card tier: each CUDA kernel against its plain PyTorch version
on the card, in float32 and float64, at the main path's shapes and at the
edges of the kernels' launch geometry (several blocks and a ragged tail for
K2; for K1 the shared-memory opt-in above 48 KB, the largest case that fits
((28, 58, 35) in f64) and the refusal above 227 KB, N = 1 and 2 where the
stage prefetch has nothing or one stage to fetch, widths that are not a
multiple of the 4 x 4 tiles, nu = 1, a batch at the AL shape, and K1 on the
AL path's unprojected LQ from real solver data; for K3 the cluster
geometry: the kernel's own plan, the f64 (28, 58, 35) ring of 3 slots for
4 stages a CTA, N below the cluster of 8 (one stage a rank), a forced ring
in f32, the refusal of ranks without stages, inputs off 16-byte alignment,
batches of 3 and 4, and bit-identical results from repeated launches). K2 runs at B = 1, 28, 130 and the merit search's 224. The
closed loop of each formulation (`build_*_mpc` + `run_dummy_sim`, humanoid23
at N = 6) runs through the kernels and against its plain twin. Needs an
NVIDIA card and `nvcc`; skipped elsewhere. This file imports no JAX, so it
also runs where JAX is not installed:

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
@pytest.mark.parametrize("B", [1, 28, 130, 224])
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
@pytest.mark.parametrize("shape", [(28, 58, 21), (28, 58, 35), (7, 12, 5), (6, 36, 10),
                                   (1, 58, 21), (2, 58, 35), (5, 13, 7), (4, 58, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_riccati_kernel_matches_plain(card, shape, dtype):
    """Every (28, 58, *) case needs the opt-in above 48 KB; (28, 58, 35) in
    f64 is the largest that fits (217 KB). N = 1 has no stage to prefetch and
    N = 2 one; (5, 13, 7) and (4, 58, 1) leave ragged 4 x 4 tiles (nu = 1: a
    single pivot)."""
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
def test_riccati_kernel_batch_al_shape(card, dtype):
    """Four instances at the AL path's (28, 58, 35): four blocks."""
    args = _lq(5, 28, 58, 35, dtype, card, batch=4)
    got = riccati.riccati_rollout_cuda(*args, reg=1e-8)
    assert got[0].shape == (4, 28, 35, 58) and got[3].shape == (4, 28, 35)
    _close(got, riccati.riccati_rollout_plain(*args, reg=1e-8), TOL[dtype], "K1 batch AL shape")


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
    """The kernel's own plan: C = min(8, N, stage data / 16 KB), as many
    slots as fit (in f64 at (28, 58, 35) a ring of 3 for 4 stages a CTA)."""
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


def _rollout_forced(args, cluster, slots):
    """K3 with a cluster size and slots per CTA that no shape's plan takes,
    through the C entry point that the tests alone use: (return code, dxs, dus)."""
    from wb_humanoid_mpc_tpu_torch.ops import _lib

    A, B = args[0], args[1]
    N, nx, nu = A.shape[-3], A.shape[-1], B.shape[-1]
    dxs = torch.full((N + 1, nx), float("nan"), dtype=A.dtype, device=A.device)
    dus = torch.full((N, nu), float("nan"), dtype=A.dtype, device=A.device)
    lib = _lib.library()
    fn = (lib.wbmpc_forward_rollout_ex_f32 if A.dtype == torch.float32
          else lib.wbmpc_forward_rollout_ex_f64)
    code = fn(*(a.data_ptr() for a in args), dxs.data_ptr(), dus.data_ptr(), 1, N, nx, nu,
              cluster, slots, torch.cuda.current_stream().cuda_stream)
    return code, dxs, dus


@pytest.mark.parametrize("case", [
    ((28, 58, 35), torch.float64, None, None),   # the plan's ring: 4 stages a CTA, 3 slots
    ((7, 12, 5), torch.float32, 7, 1),           # N below 8: one stage a rank
    ((8, 12, 5), torch.float64, 8, 1),           # the largest cluster, one stage a rank
    ((15, 35, 35), torch.float32, 2, 2),         # 8 stages a rank through 2 slots
], ids=["ring-f64", "C=N=7-f32", "C=N=8-f64", "ring-f32"])
def test_rollout_kernel_cluster_geometry(card, case):
    shape, dtype, cluster, slots = case
    args = _stages(sum(shape) + 1, *shape, dtype, card)
    if cluster is None:
        plan = rollout.rollout_plan(*shape, dtype)
        assert (plan["cluster"], plan["slots"]) == (8, 3)
        assert plan["smem_bytes"] <= 232448 and plan["max_active_clusters"] >= 1
        got = rollout.forward_rollout_cuda(*args)
    else:
        code, *got = _rollout_forced(args, cluster, slots)
        assert code == 0
    _close(got, rollout.forward_rollout_plain(*args), K3_TOL[dtype], f"K3 {case}")


def test_rollout_kernel_refuses_ranks_without_stages(card):
    """A cluster larger than N or than 8, or more slots than a rank has
    stages: refused before any launch."""
    args = _stages(3, 7, 12, 5, torch.float32, card)
    for cluster, slots in ((8, 0), (9, 0), (2, 5)):
        code, dxs, _ = _rollout_forced(args, cluster, slots)
        torch.cuda.synchronize()
        assert code != 0 and bool(dxs.isnan().all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rollout_kernel_is_bit_reproducible(card, dtype):
    """Which stages a rank folds depends on the plan alone, not on when dx
    comes: ten launches on the same inputs give the same bits."""
    args = _stages(9, 28, 58, 35, dtype, card, batch=4)
    first = rollout.forward_rollout_cuda(*args)
    for _ in range(9):
        again = rollout.forward_rollout_cuda(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rollout_kernel_unaligned_inputs(card, dtype):
    """Inputs that are views one value into a larger buffer: no array starts
    16-byte aligned, so each stage's bulk copies start at another lead."""
    args = []
    for a in _stages(8, 28, 58, 35, dtype, card):
        buf = torch.empty(a.numel() + 1, dtype=dtype, device=card)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 != 0
        args.append(view)
    got = rollout.forward_rollout_cuda(*args)
    _close(got, rollout.forward_rollout_plain(*args), K3_TOL[dtype], "K3 unaligned inputs")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rollout_kernel_batch_of_four(card, dtype):
    """Four clusters at (28, 58, 35): 32 CTAs; in f64 each through its ring."""
    args = _stages(6, 28, 58, 35, dtype, card, batch=4)
    got = rollout.forward_rollout_cuda(*args)
    assert got[0].shape == (4, 29, 58) and got[1].shape == (4, 28, 35)
    _close(got, rollout.forward_rollout_plain(*args), K3_TOL[dtype], "K3 batch of four")


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


@pytest.mark.parametrize("formulation", ["wb", "centroidal"])
def test_closed_loop_kernels_match_plain(card, formulation):
    """`build_*_mpc` + `run_dummy_sim` on humanoid23 at N = 6, f32, 0.2 s of
    stance at 50/25 Hz: the kernel run against the same loop on the plain
    versions (per tick, 2e-3 x max(1, max|ref|), the same steps); K1
    launched once per SQP iteration; K2 (whole-body only) 6 to 9 times."""
    from wb_humanoid_mpc_tpu_torch.interface import (
        build_centroidal_mpc,
        build_wb_mpc,
        mpc_files,
    )
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim

    build = build_wb_mpc if formulation == "wb" else build_centroidal_mpc
    files = mpc_files(ASSETS / "humanoid23", formulation)
    logs, counts = [], None
    for overrides in ({}, dict(rollout_backend="plain", flow_backend="plain")):
        mpc = build(*files, n_nodes=6, solver_overrides=overrides, device=card)
        riccati.reset_launches()
        fkvel.reset_launches()
        logs.append(run_dummy_sim(mpc.runtime, mpc.initial_state, 0.2, 50.0, 25.0,
                                  flow=mpc.model.flow_map))
        if counts is None:
            counts = (riccati.LAUNCHES, fkvel.LAUNCHES)
    got, ref = logs
    assert np.isfinite(got.states).all()
    for a, b in ((got.states, ref.states), (got.inputs, ref.inputs)):
        assert np.abs(a - b).max() <= 2e-3 * max(1.0, np.abs(b).max())
    assert [s.step_size for s in got.solve_stats] == [s.step_size for s in ref.solve_stats]
    n_iter = sum(s.iterations for s in got.solve_stats)
    assert counts[0] == n_iter
    if formulation == "wb":
        assert 6 * n_iter <= counts[1] <= 9 * n_iter
    else:
        assert counts[1] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_riccati_kernel_batch_of_eight(card, dtype):
    """K1 at the batched solve's leading batch of 8, (28, 58, 21): 8 blocks."""
    args = _lq(8, 28, 58, 21, dtype, card, batch=8)
    before = riccati.LAUNCHES
    got = riccati.riccati_rollout_cuda(*args, reg=1e-8)
    assert riccati.LAUNCHES == before + 1
    assert got[0].shape == (8, 28, 21, 58) and got[2].shape == (8, 29, 58)
    _close(got, riccati.riccati_rollout_plain(*args, reg=1e-8), TOL[dtype], "K1 batch of eight")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_batched_solve_kernels_match_plain(card, dtype):
    """A B = 4 batched solve (`make_batched_solver`, humanoid23, N = 6, two
    SQP iterations, seeded perturbed x0) through the kernels against the same
    solve on the plain versions: per instance 2e-3 x max(1, max|ref|) in f32,
    1e-9 in f64, the same steps; K1 once per batched iteration."""
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_inputs

    pb = build_wb_problem(ASSETS / "humanoid23", 6, device=card, dtype=dtype)
    inputs = batched_inputs(pb, 4, seed=1, spread=0.02)
    sols = []
    for backend in ("cuda", "plain"):
        cfg = SqpSolverConfig(n_nodes=6, dt=pb.cfg.sqp.dt, sqp_iterations=2,
                              rollout_backend=backend, flow_backend=backend)
        solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=card)
        riccati.reset_launches()
        sols.append(solve(0.0, *inputs))
        if backend == "cuda":
            assert riccati.LAUNCHES == 2
    got, ref = sols
    tol = 2e-3 if dtype == torch.float32 else 1e-9
    for a, b in ((got.traj.xs, ref.traj.xs), (got.traj.us, ref.traj.us)):
        for i in range(4):
            assert float((a[i] - b[i]).abs().max()) <= tol * max(1.0, float(b[i].abs().max()))
    assert got.step_size.tolist() == ref.step_size.tolist()
    assert bool(torch.isfinite(got.cost).all())


def test_mrt_pipeline_on_the_card(card):
    """A 2 s `MrtPipeline` run (humanoid23 whole-body, N = 6, f32): the
    solver thread on the card, a 500 Hz control loop in this thread pushing
    replayed policy states and computing torques with `WBMrtController` on
    its own stream; at least one policy, no failure, finite torques, the
    thread joined."""
    import time

    from wb_humanoid_mpc_tpu_torch.interface import build_wb_mpc, mpc_files
    from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline
    from wb_humanoid_mpc_tpu_torch.mpc.controller import WBMrtController

    mpc = build_wb_mpc(*mpc_files(ASSETS / "humanoid23", "wb"), n_nodes=6, device=card)
    ctrl = WBMrtController(mpc.model, device=card)
    assert ctrl.stream is not None and ctrl.stream != torch.cuda.current_stream(card)
    x = np.asarray(mpc.initial_state, dtype=float)
    pipe = MrtPipeline(mpc.runtime, nx=x.shape[0], device=card)
    pipe.start()
    taus = []
    try:
        t_start = time.perf_counter()
        k = 0
        while time.perf_counter() - t_start < 2.0 and not pipe.failed:
            t = 0.002 * k
            pipe.push_observation(t, x, np.zeros(4))
            pol = pipe.get_policy()
            action = ctrl.compute(t, x, pol)
            taus.append(action.total_torque(x[6:29], x[35:58]))
            if pol is not None:
                x = np.asarray(pol.evaluate(t + 0.002)[0], dtype=float)
            k += 1
            time.sleep(max(0.0, t_start + 0.002 * k - time.perf_counter()))
    finally:
        pipe.stop(timeout=60.0)
    assert pipe._thread is None
    assert not pipe.failed and pipe.solve_count >= 1
    assert np.isfinite(np.asarray(taus)).all()


def test_sharded_solve_on_the_card(card):
    """A 1 x 2 `gloo` sharded solve on the card (`make_sharded_sqp_solver`,
    humanoid23 walk, N = 6, B = 2, two SQP iterations, f32 and f64, both
    ranks on this card, one spawn): every rank's whole solution against
    `make_batched_solver` on the card (`dryrun_multichip`'s gates: max |dxs|
    below 2e-2 in f32, 1e-4 in f64) and against the same sharded solve on
    K2's plain twin (2e-3 / 1e-9 x max(1, max|ref|)), the same steps; K2
    launched 9 times an SQP iteration on each rank, never by the twin."""
    from wb_humanoid_mpc_tpu_torch.parallel import dryrun
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks

    N, B, iters = 6, 2, 2
    dtypes = {"float32": (2e-2, 2e-3), "float64": (1e-4, 1e-9)}
    cases = [(dryrun.sharded_sqp_case, dict(robot="humanoid23", n_nodes=N, batch=B, n_dp=1,
                                            n_h=2, backend="gloo", device="cuda", dtype=dt,
                                            iterations=iters, flow_backend=fb))
             for dt in dtypes for fb in ("auto", "plain")]
    ranks = run_ranks(dryrun.run_cases, 2, "gloo", "cuda", cases, timeout_s=600.0)
    for k, (dt, (gate, tol)) in enumerate(dtypes.items()):
        pb, *inputs = dryrun.walking_problem("humanoid23", N, B, device=card,
                                             dtype=getattr(torch, dt))
        ref = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp,
                                  SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt,
                                                  sqp_iterations=iters), device=card)(0.0, *inputs)
        ref_xs = ref.traj.xs.cpu().numpy()
        for rank in ranks:
            got, twin = rank[2 * k], rank[2 * k + 1]
            assert got["k2_launches"] == 9 * iters and twin["k2_launches"] == 0
            assert float(np.abs(got["xs"] - ref_xs).max()) < gate, dt
            np.testing.assert_array_equal(got["step_size"], ref.step_size.cpu().numpy())
            for name in ("xs", "us"):
                scale = max(1.0, float(np.abs(twin[name]).max()))
                assert float(np.abs(got[name] - twin[name]).max()) <= tol * scale, (dt, name)
            np.testing.assert_array_equal(got["step_size"], twin["step_size"])
