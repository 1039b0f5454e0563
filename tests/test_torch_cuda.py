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
batches of 3 and 4, and bit-identical results from repeated launches; K3
in the split LQ solve, after `backward_pass`, against `forward_pass` and
K1's fused solve on the projected and the AL path's stance LQ at N = 28).
Every solver configuration (the main path, AL + merit, parallel Riccati,
midpoint and exact sensitivities, DDP, the staged solver) at N = 28 on the
kernels against the same configuration on the plain versions, with its
launch counts a solve. K2 runs at B = 1, 28, 130 and the merit search's 224;
its flow variant (the whole-body flow map in one launch) at the solve's 29,
58 and 174 rows and at 7168, with stance and walking wrenches, and every K2
launch of a graphed whole-body solve is the flow variant. The
closed loop of each formulation (`build_*_mpc` + `run_dummy_sim`, humanoid23
at N = 6) runs through the kernels and against its plain twin; the launch
CLI's `dummy-sim` and, where the machine has mujoco, a short MuJoCo loop
run on the card with their launch counts checked; so does the bench entry
(`tools.bench.main`, N = 28); `solver/priccati.py::_combine` on the card
gives the CPU's non-finite pattern on a singular combine matrix, without a
raise. The compiled sharded solve: graphed against eager on a 1 x 1
`nccl` mesh (collectives inside the graphs) and a 1 x 2 `gloo` mesh (the
graphs cut at each collective). The compiled solve (`solver/graphs.py`):
graphed against eager on the main path, t0 read at every replay, the recapture after a gain update,
the launch counters under replay, a failed capture raising, and the MRT
solver thread capturing beside the controller. The compiled control tick:
each MRT controller's graphed feed-forward, the dummy plant's graphed RK4
step (on a flow that reads t) and the staged solver's phase graphs against
their eager twins (and the staged launch counts against the eager ones),
controllers capturing and replaying in one thread while another captures
and replays a solve, and a failed controller capture raising. The
centroidal MPC's node params as one graph: replays against the eager
params over ticks of other target states, the graph kept across a gain
update, and one `params` replay inside `refs` a trace record. The
benchmark's whole-body solve that K1's float32 summation order once sent
4.3e-2 from float64 (`tests/_saved_solve.py`), graphed and eager, within
the benchmark's limit of the plain reference in float64. Needs an
NVIDIA card and `nvcc`; skipped elsewhere. This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 as tests/test_ops_fkvel.py's Mosaic tier (f32 rtol 1e-4,
atol 5e-6), its flow variant as tests/test_torch_fkvel.py holds the flow map
(f32 rtol 2e-4, atol 2e-5, f64 1e-10; against the plain version in float64 on
the same inputs, as tests/test_torch_kernel_emulation_flow.py), K1 as tests/test_ops_riccati.py's (f32 rtol 1e-3, atol 5e-4);
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


FLOW_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
            torch.float64: dict(rtol=1e-10, atol=1e-10)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("wrenches", ["stance", "walk"])
@pytest.mark.parametrize("robot", ["humanoid23", "toy_biped"])
@pytest.mark.parametrize("B", [29, 58, 174, 7168])
def test_fkvel_flow_kernel_matches_plain(card, B, robot, wrenches, dtype):
    """`flow_map_batch` on CUDA tensors is one launch of K2's flow variant,
    counted in LAUNCHES and FLOW_LAUNCHES, and gives the plain flow map
    (computed in float64 on the same inputs) near a standing pose: stance
    wrenches share the weight between the feet, walking ones put it all on
    the left foot."""
    model = load_wb_model(ASSETS / robot)[1]
    r = model.robot
    rng = np.random.default_rng(B + len(robot) + len(wrenches))
    q = np.concatenate([rng.normal(size=(B, 2)) * 0.5, 0.75 + rng.normal(size=(B, 1)) * 0.03,
                        rng.normal(size=(B, 3)) * 0.1, rng.normal(size=(B, r.n_joints)) * 0.3], 1)
    share = (0.5, 0.5) if wrenches == "stance" else (1.0, 0.0)
    us = [np.concatenate([rng.normal(size=(B, 2)) * 5.0 * s,
                          s * r.total_mass * r.gravity + rng.normal(size=(B, 1)) * 10.0 * s,
                          rng.normal(size=(B, 3)) * 2.0 * s], 1) for s in share]
    xs = torch.as_tensor(np.concatenate([q, rng.normal(size=(B, r.nq)) * 0.5], 1), dtype=dtype,
                         device=card)
    us = torch.as_tensor(np.concatenate(us + [rng.normal(size=(B, r.n_joints)) * 3.0], 1),
                         dtype=dtype, device=card)
    before = (fkvel.LAUNCHES, fkvel.FLOW_LAUNCHES)
    got = model.flow_map_batch(None, xs, us)          # "auto" on CUDA tensors: the flow variant
    assert (fkvel.LAUNCHES, fkvel.FLOW_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = model.flow_map_batch(None, xs.double(), us.double(), backend="plain")
    torch.testing.assert_close(got.double(), ref, **FLOW_TOL[dtype],
                               msg=lambda m: f"K2 flow {robot} {wrenches} B={B}: {m}")


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


# ---- the split LQ solve and every solver configuration, at full width ----

FULL_N = 28        # humanoid23's stance problem at the main path's N
SOLVE_TOL = 2e-3   # x max(1, max|ref|): a solve on the kernels against the plain versions
N_SOLVES = 3       # warm-started solves a configuration, the first capturing its graphs


@pytest.mark.parametrize("lq_kind", ["projected", "al"])
def test_split_lq_solve_matches_the_fused_solve(card, lq_kind):
    """The split LQ solve, the sequential `backward_pass` and then K3
    (`forward_rollout`, one launch), on humanoid23's damped stance LQ at
    N = 28 in f32: the main path's projected LQ (nz 21) and the AL path's
    unprojected one (nu 35), from a start off the trajectory. Against
    `forward_pass` on the same gains (K3's f32 tolerance, 1e-5 x max(1,
    max|ref|)) and against K1's fused solve of the same LQ (K1's f32
    tolerance, atol 5e-4 + rtol 1e-3 |ref|)."""
    from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq
    from wb_humanoid_mpc_tpu_torch.solver.riccati import backward_pass, forward_pass

    pb = build_wb_problem(ASSETS / "humanoid23", FULL_N, device=card, dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=FULL_N, dt=pb.cfg.sqp.dt)
    fns = make_lq_functions(pb.ocp, pb.model.flow_map, cfg.dt, FULL_N, pb.bp, sensitivity="node",
                            flow_batch=pb.model.flow_map_batch)
    times = cfg.dt * torch.arange(FULL_N + 1, dtype=torch.float32, device=card)
    if lq_kind == "projected":
        lq = fns.lq_approximation(pb.traj, times, pb.params, pb.lam, min(cfg.rho, 1.0))
        lq = levenberg_damp(project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)[0], cfg.reg)
    else:
        lq = levenberg_damp(fns.lq_approximation(pb.traj, times, pb.params, pb.lam, cfg.rho),
                            cfg.reg)
    assert lq.B.shape == (FULL_N, 58, 21 if lq_kind == "projected" else 35)
    rng = np.random.default_rng(5)
    dx0 = pb.x0 - pb.traj.xs[0] + torch.as_tensor(rng.normal(size=58) * 0.01,
                                                   dtype=torch.float32, device=card)
    gains = backward_pass(lq, cfg.reg_num)
    before = rollout.LAUNCHES
    got = rollout.forward_rollout(lq, gains, dx0, backend="cuda")
    assert rollout.LAUNCHES == before + 1
    _close(got, forward_pass(lq, gains, dx0), K3_TOL[torch.float32],
           f"split solve {lq_kind} vs forward_pass")
    fused = riccati.riccati_rollout(lq, dx0, cfg.reg_num, backend="cuda")
    for what, a, b in zip(("dxs", "dus"), got, fused):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4,
                                   msg=lambda m: f"split solve {lq_kind} {what} vs K1: {m}")


def _exactly(k1, k2):
    """Launch counts {kernel: (least, most)} in n solves: k1 and k2 a solve."""
    return lambda n: {"K1": (k1 * n, k1 * n), "K2": (k2 * n, k2 * n), "K3": (0, 0)}


def _ladder(k1, k2_lq):
    """The same, with k2_lq K2 launches in the LQ and the two-stage filter
    ladder: one or two candidate sweeps of 3 each."""
    return lambda n: {"K1": (k1 * n, k1 * n), "K2": ((k2_lq + 3) * n, (k2_lq + 6) * n),
                      "K3": (0, 0)}


SOLVER_CONFIGS = {   # name: (factory, config fields, launch counts in n solves)
    "main": ("sqp", {}, _ladder(1, 3)),
    "al+merit": ("sqp", dict(equality_handling="al", line_search="merit"), _exactly(1, 11)),
    "parallel_riccati": ("sqp", dict(parallel_riccati=True), _ladder(0, 3)),
    "midpoint": ("sqp", dict(sensitivity="midpoint"), _ladder(1, 0)),
    "exact": ("sqp", dict(sensitivity="exact"), _ladder(1, 0)),
    "ddp": ("ddp", dict(equality_handling="al"), _exactly(0, 0)),
    "staged": ("staged", {}, _exactly(1, 10)),
}


@pytest.mark.parametrize("name", list(SOLVER_CONFIGS))
def test_solver_configuration_kernels_match_plain(card, name):
    """Each solver configuration at full width (humanoid23's stance problem,
    N = 28, f32, one SQP iteration a solve), as a user gets it on the card
    (CUDA graphs, the staged solver one a phase; DDP eager): the main path
    (projection + filter), AL + merit, parallel Riccati, midpoint and exact
    sensitivities, DDP and the staged solver. N_SOLVES warm-started solves
    launch K1, K2 and K3 as often as the configuration implies (a replay
    counts the launches its graph holds). The first solve against the same
    configuration on the plain versions (`rollout_backend="plain"`,
    `flow_backend="plain"`): xs, us and lam within SOLVE_TOL x max(1,
    max|ref|), the same accepted step, a finite cost and g_norm."""
    import dataclasses

    from wb_humanoid_mpc_tpu_torch.solver.ddp import make_ddp_solver
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_sqp_solver, make_staged_sqp_solver

    kind, fields, expect = SOLVER_CONFIGS[name]
    factory = {"sqp": make_sqp_solver, "ddp": make_ddp_solver,
               "staged": make_staged_sqp_solver}[kind]
    pb = build_wb_problem(ASSETS / "humanoid23", FULL_N, device=card, dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=FULL_N, dt=pb.cfg.sqp.dt, **fields)

    def run(solve, traj, lam):
        out = solve(0.0, pb.x0, traj, pb.params, lam)
        return out[0] if kind == "staged" else out   # the staged solver adds its phase times

    solve = factory(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=card)
    for mod in (riccati, fkvel, rollout):
        mod.reset_launches()
    got = run(solve, pb.traj, pb.lam)
    traj, lam = got.traj, got.lam
    for _ in range(N_SOLVES - 1):
        sol = run(solve, traj, lam)
        traj, lam = sol.traj, sol.lam
    torch.cuda.synchronize()
    seen = {"K1": riccati.LAUNCHES, "K2": fkvel.LAUNCHES, "K3": rollout.LAUNCHES}
    for kernel, (lo, hi) in expect(N_SOLVES).items():
        assert lo <= seen[kernel] <= hi, (f"{name}: {kernel} launched {seen[kernel]} times in "
                                          f"{N_SOLVES} solves, expected {lo}..{hi}")
    plain = factory(pb.ocp, pb.model.flow_map, pb.bp,
                    dataclasses.replace(cfg, rollout_backend="plain", flow_backend="plain"),
                    device=card)
    ref = run(plain, pb.traj, pb.lam)
    parts = []
    for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us),
                       ("lam", got.lam, ref.lam)):
        err, limit = float((a - b).abs().max()), SOLVE_TOL * max(1.0, float(b.abs().max()))
        assert err <= limit, f"{name} {what}: kernels vs plain {err:.3e} beyond {limit:.3e}"
        parts.append(f"|d{what}| {err:.3e}")
    assert float(got.step_size) == float(ref.step_size), (float(got.step_size),
                                                         float(ref.step_size))
    assert np.isfinite(float(got.cost)) and np.isfinite(float(got.g_norm))
    print(f"{name}: vs plain {', '.join(parts)}; step {float(got.step_size)}; launches in "
          f"{N_SOLVES} solves {seen}")


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


def test_graphed_sharded_solve_matches_eager_on_the_card(card):
    """`make_sharded_sqp_solver`'s CUDA graphs (`GraphedShardedSolve`)
    against its eager twin (`dryrun.sharded_graphs_case`: humanoid23 walk,
    two SQP iterations, f64, every residual shifted by 0.05 sin(t), two
    calls of other t0 and x0s): on a 1 x 1 `nccl` mesh (N = 6, B = 2) one
    graph an iteration and one for the final gathers, the collectives
    inside; on a 1 x 2 `gloo` mesh (N = 6, B = 2) and a 2 x 2 one, batch
    and horizon both split, at N = 28 (B = 4, four ranks on this card), one
    graph a part, the 13 collectives between the replays. The same
    solutions within 1e-9 x max(1, max|ref|) (expected 0) and the same
    steps, both calls (the second shows that t0 is read at every replay);
    K2 9 and the collectives 11 times an iteration (+2 gathers) on every
    rank, every call."""
    # by its directory, which pytest puts on sys.path: a package named
    # `tests` installed elsewhere may shadow this repo's `tests.`
    from _graphs_common import TimedPortOcp
    from wb_humanoid_mpc_tpu_torch.parallel import dryrun
    from wb_humanoid_mpc_tpu_torch.parallel.multihost import run_ranks

    iters = 2
    case = dict(robot="humanoid23", device="cuda", dtype="float64", iterations=iters,
                ocp_cls=TimedPortOcp)
    meshes = (("nccl", 1, 1, 6, 2, 0), ("gloo", 1, 2, 6, 11, 13), ("gloo", 2, 2, 28, 11, 13))
    for backend, n_dp, n_h, N, n_graphs, between in meshes:
        ranks = run_ranks(dryrun.run_cases, n_dp * n_h, backend, "cuda",
                          [(dryrun.sharded_graphs_case,
                            dict(case, n_nodes=N, batch=2 * n_dp, n_dp=n_dp, n_h=n_h,
                                 backend=backend))],
                          timeout_s=600.0)
        assert sorted(r["coords"] for (r,) in ranks) == [(i, j) for i in range(n_dp)
                                                         for j in range(n_h)]
        for (r,) in ranks:
            assert r["report"]["graphs"] == n_graphs, (backend, n_dp, n_h, r["report"])
            assert r["report"]["eager_collectives"] == between, (backend, n_dp, n_h, r["report"])
            for call, (got, ref) in enumerate(zip(r["graphed"], r["eager"])):
                for name in ("xs", "us", "cost", "g_norm", "defect_norm"):
                    scale = max(1.0, float(np.abs(ref[name]).max()))
                    err = float(np.abs(got[name] - ref[name]).max())
                    assert err <= 1e-9 * scale, (backend, n_dp, n_h, call, name, err)
                np.testing.assert_array_equal(got["step_size"], ref["step_size"])
            assert r["k2_launches"] == [9 * iters] * 2, (backend, n_dp, n_h, r["k2_launches"])
            assert r["collectives"] == [{"all_gather": 6 * iters + 2,
                                         "all_reduce": 5 * iters}] * 2, \
                (backend, n_dp, n_h, r["collectives"])


def test_launch_dummy_sim_on_the_card(card, tmp_path):
    """The launch CLI as a user runs it, on the card (humanoid23 whole-body,
    N = 6, f32, 0.2 s at 50 / 25 Hz, `--log-csv`): K1 once per SQP
    iteration, K2 6 to 9 times, finite states, one CSV row per tick."""
    from wb_humanoid_mpc_tpu_torch.tools import launch
    from wb_humanoid_mpc_tpu_torch.tools.observation_logger import ObservationLogger

    csv_path = str(tmp_path / "obs.csv")
    riccati.reset_launches()
    fkvel.reset_launches()
    out = launch.main(["dummy-sim", "--formulation", "wb", "--n-nodes", "6", "--duration",
                       "0.2", "--mrt-freq", "50", "--mpc-freq", "25", "--log-csv", csv_path])
    torch.cuda.synchronize()
    log = out["log"]
    n_iter = sum(s.iterations for s in log.solve_stats)
    assert riccati.LAUNCHES == n_iter
    assert 6 * n_iter <= fkvel.LAUNCHES <= 9 * n_iter
    assert np.isfinite(log.states).all()
    _, data = ObservationLogger.load_csv(csv_path)
    assert data.shape[0] == len(log.times) == 10


def test_mujoco_loop_on_the_card(card):
    """`run_mujoco_closed_loop` on humanoid23's MJCF, whole-body, N = 6, f32,
    0.3 s synchronous (500 Hz MRT, 25 Hz MPC), the solves on the card: no
    reset, finite positions, K1 once per SQP iteration and K2 6 to 9 times.
    Needs mujoco on the card's machine."""
    pytest.importorskip("mujoco")
    from wb_humanoid_mpc_tpu_torch.interface import build_wb_mpc, mpc_files
    from wb_humanoid_mpc_tpu_torch.mpc.controller import WBMrtController
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import run_mujoco_closed_loop
    from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface

    mpc = build_wb_mpc(*mpc_files(ASSETS / "humanoid23", "wb"), n_nodes=6, device=card)
    lay, x0 = mpc.model.layout, mpc.initial_state
    sim = MujocoSimInterface(str(ASSETS / "humanoid23" / "humanoid23.xml"),
                             initial_joint_positions=dict(zip(mpc.model.robot.joint_names,
                                                              map(float, lay.joint_angles(x0)))),
                             initial_base_pos=(0.0, 0.0, float(lay.base_position(x0)[2])))
    riccati.reset_launches()
    fkvel.reset_launches()
    log = run_mujoco_closed_loop(mpc, WBMrtController(mpc.model, device=card), sim, 0.3,
                                 500.0, 25.0)
    torch.cuda.synchronize()
    assert log.n_resets == 0
    assert np.isfinite(log.base_positions).all()
    n_iter = sum(s.iterations for s in log.solve_stats)
    assert riccati.LAUNCHES == n_iter
    assert 6 * n_iter <= fkvel.LAUNCHES <= 9 * n_iter


def test_bench_entry_on_the_card(card, capsys):
    """`tools.bench.main` as a user runs it (humanoid23, N = 28, f32) with
    `--timed 5`: one JSON line with `bench.py`'s four keys, a finite value,
    K1 once per solve (1 warm-up + 5 + 10 latency samples), K2 6 to 9
    times."""
    import json

    from wb_humanoid_mpc_tpu_torch.tools import bench

    riccati.reset_launches()
    fkvel.reset_launches()
    out = bench.main(["--timed", "5"])
    torch.cuda.synchronize()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert list(out) == ["metric", "value", "unit", "vs_baseline"]
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 60.0, 3)
    n_solves = 1 + 5 + 10
    assert riccati.LAUNCHES == n_solves
    assert 6 * n_solves <= fkvel.LAUNCHES <= 9 * n_solves


def test_combine_on_the_card(card):
    """`_combine` on CUDA tensors, with I + C_i J_j exactly singular in the
    first element (C_i = I, J_j = -I) and one zero pivot in the second: no
    raise, the CPU's non-finite entries in the same places, the finite ones
    equal to 1e-12 (f64)."""
    from wb_humanoid_mpc_tpu_torch.solver.priccati import _combine, _Elem

    rng = np.random.default_rng(0)
    n, batch = 5, 3

    def elem():
        W, V = rng.standard_normal((2, batch, n, n))
        return dict(A=rng.standard_normal((batch, n, n)), b=rng.standard_normal((batch, n)),
                    C=0.1 * W @ np.swapaxes(W, -1, -2), J=0.1 * V @ np.swapaxes(V, -1, -2),
                    eta=rng.standard_normal((batch, n)))

    ej, ei = elem(), elem()
    ei["C"][0], ej["J"][0] = np.eye(n), -np.eye(n)
    ei["C"][1], ej["J"][1] = np.eye(n), -np.diag([1.0] + [0.0] * (n - 1))

    def run(dev):
        return _combine(_Elem(**{k: torch.as_tensor(v, device=dev) for k, v in ej.items()}),
                        _Elem(**{k: torch.as_tensor(v, device=dev) for k, v in ei.items()}))

    got, ref = run(card), run("cpu")
    torch.cuda.synchronize()
    for name, a, b in zip(_Elem._fields, got, ref):
        a = a.cpu()
        assert torch.equal(torch.isfinite(a), torch.isfinite(b)), name
        assert not torch.isfinite(b[:2]).all() and torch.isfinite(b[2]).all(), name
        ok = torch.isfinite(b)
        torch.testing.assert_close(a[ok], b[ok], rtol=0.0, atol=1e-12, msg=name)


# ---- the compiled solve (`solver/graphs.py`): CUDA graphs around the SQP solve ----

class _TimedOcp:
    """Mixin: every stage and terminal residual shifted by 0.05 sin(t), so that
    a solve at another time than its call's t0 (a time baked into a graph)
    changes the answer (tests/_graphs_cases.py does the same on the CPU)."""

    def fused_node(self, t, x, u, p):
        terms, xdot = super().fused_node(t, x, u, p)
        return terms._replace(r=terms.r + 0.05 * torch.sin(t)[..., None]), xdot

    def terminal_residual(self, t, x, p):
        return super().terminal_residual(t, x, p) + 0.05 * torch.sin(t)[..., None]


def _graphed_and_eager(card, n_nodes, timed=False, **fields):
    from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_sqp_solver

    pb = build_wb_problem(ASSETS / "humanoid23", n_nodes, device=card, dtype=torch.float32)
    ocp = pb.ocp
    if timed:
        ocp = type("TimedWholeBodyOcp", (_TimedOcp, WholeBodyOcp), {})(model=pb.model,
                                                                       cfg=pb.cfg)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, **fields)
    graphed = make_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device=card)
    eager = make_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device=card, graphs=False)
    assert isinstance(graphed, GraphedSqpSolve) and not isinstance(eager, GraphedSqpSolve)
    return pb, graphed, eager


def _max_scaled(got, ref):
    """(the largest ratio of max |got - ref| to its limit 2e-3 x max(1,
    max|ref|), each of xs and us against its own scale; a line that gives
    each field's error and limit)."""
    ratio, parts = 0.0, []
    for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us)):
        err = float((a - b).abs().max())
        limit = 2e-3 * max(1.0, float(b.abs().max()))
        ratio = max(ratio, err / limit)
        parts.append(f"{what} {err:.3e} (limit {limit:.3e})")
    return ratio, ", ".join(parts)


def _moved(a, b):
    """max |a - b| over xs and us of two solutions."""
    return max(float((a.traj.xs - b.traj.xs).abs().max()),
               float((a.traj.us - b.traj.us).abs().max()))


def test_graphed_solve_matches_eager_on_the_card(card):
    """The main path's solve (humanoid23, N = 28, f32, one iteration) as CUDA
    graphs against its eager twin on the same inputs, twice (the capturing
    call and a replaying one): 2e-3 x max(1, max|ref|), the same step; the
    maximum is printed (the same kernels on the same values: expected 0)."""
    pb, graphed, eager = _graphed_and_eager(card, 28, sqp_iterations=1)
    traj, lam = pb.traj, pb.lam
    for call in ("capture", "replay"):
        got = graphed(0.0, pb.x0, traj, pb.params, lam)
        ref = eager(0.0, pb.x0, traj, pb.params, lam)
        ratio, line = _max_scaled(got, ref)
        print(f"graphed vs eager ({call}): max|d| {line}")
        assert ratio <= 1.0, line
        assert float(got.step_size) == float(ref.step_size)
        traj, lam = got.traj, got.lam


def test_graphed_solve_reads_t0_at_every_replay(card):
    """t0 is a buffer the graphs read: on a time-dependent OCP, replays at
    t0 = 0.5 and 0.9 after a capture at 0 give the eager solve at those
    times, not at the capture's: their distance to it is within 2e-3 x
    max(1, max|ref|) and under a thousandth of what the change of t0 moves
    the solution."""
    pb, graphed, eager = _graphed_and_eager(card, 6, timed=True, sqp_iterations=2)
    at0 = graphed(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    for t0 in (0.5, 0.9):
        got = graphed(t0, pb.x0, pb.traj, pb.params, pb.lam)
        ref = eager(t0, pb.x0, pb.traj, pb.params, pb.lam)
        ratio, line = _max_scaled(got, ref)
        err, moved = _moved(got, ref), _moved(got, at0)
        print(f"t0 {t0}: graphed vs eager {line}; moved by the change of t0 {moved:.3e}")
        assert ratio <= 1.0, f"t0 {t0}: {line}"
        assert err <= 1e-3 * moved, f"t0 {t0}: {err:.3e} against a move of {moved:.3e}"


def test_gains_rebuild_recaptures(card):
    """A gain update drops the runtime's graphed solve and the recovery
    solve that shares its graphs (they read the old weights), and the next
    solve captures new ones. On the call the runtime made after the update,
    the new graphs equal an eager solve of the updated OCP within 2e-3 x
    max(1, max|ref|) of each field, and their distance to it is under a
    thousandth of what doubling Q moves the solution (an eager solve of an
    OCP built with the old weights on the same call)."""
    from wb_humanoid_mpc_tpu_torch.interface import build_wb_mpc, mpc_files
    from wb_humanoid_mpc_tpu_torch.mpc.gains import GainUpdate
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_sqp_solver

    files = mpc_files(ASSETS / "humanoid23", "wb")
    mpc = build_wb_mpc(*files, n_nodes=6, device=card)
    before = build_wb_mpc(*files, n_nodes=6, device=card)   # keeps the old weights
    rt = mpc.runtime
    x = np.asarray(mpc.initial_state, dtype=float)
    rt.advance(0.0, x, np.zeros(4))
    old = rt.solve_fn
    assert isinstance(old, GraphedSqpSolve) and len(old.sets) == 1
    assert rt.recovery_solve_fn.sets is old.sets and rt.recovery_solve_fn.iterations == 12
    mpc.gains.apply(GainUpdate(term="Q", values=2.0 * np.asarray(mpc.cfg.Q)))
    assert rt.solve_fn is not old and not old.sets and not rt.solve_fn.sets
    assert rt.recovery_solve_fn.sets is rt.solve_fn.sets
    new = rt.solve_fn
    cfg, bp = new.it.cfg, mpc.ocp.barrier_params(card, torch.float32)
    eager = make_sqp_solver(mpc.ocp, mpc.model.flow_map, bp, cfg, device=card, graphs=False)
    calls = []
    orig = new.__call__

    def spy(*args):
        calls.append(args)
        return orig(*args)

    rt.solve_fn = spy
    rt.advance(0.04, x, np.zeros(4))
    assert len(new.sets) == 1
    got = orig(*calls[0])
    ref = eager(*calls[0])
    old_ref = make_sqp_solver(before.ocp, before.model.flow_map,
                              before.ocp.barrier_params(card, torch.float32), cfg, device=card,
                              graphs=False)(*calls[0])
    ratio, line = _max_scaled(got, ref)
    err, moved = _moved(got, ref), _moved(got, old_ref)
    print(f"gains rebuild: graphed vs eager {line}; moved by doubling Q {moved:.3e}")
    assert ratio <= 1.0, line
    assert err <= 1e-3 * moved, f"{err:.3e} against a move of {moved:.3e}"


def test_graphed_launch_counters_advance_per_replay(card):
    """K1 and K2 count every launch a replay makes, as the eager twin's
    wrappers do on the same calls: K1 once per iteration, K2 6 to 9 times,
    the two counts equal; every K2 launch is the flow variant (each flow-map
    call one launch)."""
    pb, graphed, eager = _graphed_and_eager(card, 28, sqp_iterations=2)
    graphed(0.0, pb.x0, pb.traj, pb.params, pb.lam)   # capture
    counts = []
    for solve in (graphed, eager):
        riccati.reset_launches()
        fkvel.reset_launches()
        traj, lam = pb.traj, pb.lam
        for _ in range(3):
            sol = solve(0.0, pb.x0, traj, pb.params, lam)
            traj, lam = sol.traj, sol.lam
        torch.cuda.synchronize()
        counts.append((riccati.LAUNCHES, fkvel.LAUNCHES, fkvel.FLOW_LAUNCHES))
    assert counts[0] == counts[1], counts
    assert counts[0][0] == 6 and 36 <= counts[0][1] <= 54, counts
    assert counts[0][2] == counts[0][1], counts


def test_graph_capture_failure_raises(card, monkeypatch):
    """An operation that reads the device inside a piece of the iteration
    (here `.item()` in the damping) makes the capture fail: the solve
    raises, naming the operation, and does not run eagerly instead."""
    from wb_humanoid_mpc_tpu_torch.solver import sqp

    orig = sqp.levenberg_damp

    def reads_the_device(lq, reg):
        if float(lq.Quu.abs().max().item()) < 0:
            raise AssertionError("unreachable")
        return orig(lq, reg)

    monkeypatch.setattr(sqp, "levenberg_damp", reads_the_device)
    pb, graphed, _ = _graphed_and_eager(card, 6, sqp_iterations=1)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the SQP iteration's A head "
                                           "failed at .*reads_the_device"):
        graphed(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    (gs,) = graphed.sets.values()
    assert not gs.graphs
    torch.cuda.synchronize()


def test_graphed_mrt_pipeline_captures_beside_the_controller(card):
    """The MRT solver thread captures its graphs while this thread runs the
    500 Hz loop with `WBMrtController` on its own stream (thread-local
    capture), then replays them: policies come, no failure."""
    import threading
    import time

    from wb_humanoid_mpc_tpu_torch.interface import build_wb_mpc, mpc_files
    from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline
    from wb_humanoid_mpc_tpu_torch.mpc.controller import WBMrtController
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphSet

    mpc = build_wb_mpc(*mpc_files(ASSETS / "humanoid23", "wb"), n_nodes=6, device=card)
    ctrl = WBMrtController(mpc.model, device=card)
    threads = []
    orig = GraphSet._capture_all

    def capture_all(self):
        threads.append(threading.current_thread().name)
        orig(self)

    GraphSet._capture_all = capture_all
    x = np.asarray(mpc.initial_state, dtype=float)
    pipe = MrtPipeline(mpc.runtime, nx=x.shape[0], device=card)
    pipe.start()
    ticks = 0
    try:
        t_start = time.perf_counter()
        while (time.perf_counter() - t_start < 3.0 or pipe.solve_count < 3) and not pipe.failed:
            if time.perf_counter() - t_start > 60.0:
                break
            t = 0.002 * ticks
            pipe.push_observation(t, x, np.zeros(4))
            pol = pipe.get_policy()
            ctrl.compute(t, x, pol)
            if pol is not None:
                x = np.asarray(pol.evaluate(t + 0.002)[0], dtype=float)
            ticks += 1
            time.sleep(max(0.0, t_start + 0.002 * ticks - time.perf_counter()))
    finally:
        GraphSet._capture_all = orig
        pipe.stop(timeout=60.0)
    assert not pipe.failed, pipe.error
    assert pipe.solve_count >= 3 and ticks > pipe.solve_count
    assert threads and set(threads) == {"mpc-solver"}, threads
    assert len(mpc.runtime.solve_fn.sets) == 1


# ---- the compiled control tick: controllers, plant step, staged phases ----

GRAPH_TOL = 1e-6   # x max(1, max|ref|): a graph against its eager twin (expected 0)


def _scaled(a, b) -> tuple[float, float]:
    """(max |a - b|, its limit GRAPH_TOL x max(1, max|b|)) of numpy arrays
    or tensors."""
    a, b = (np.asarray(x.double().cpu() if isinstance(x, torch.Tensor) else x, np.float64)
            for x in (a, b))
    return float(np.abs(a - b).max()), GRAPH_TOL * max(1.0, float(np.abs(b).max()))


def _h23_model(card, form):
    from wb_humanoid_mpc_tpu_torch.interface import (
        build_centroidal_mpc,
        build_wb_mpc,
        mpc_files,
    )

    build = build_wb_mpc if form == "wb" else build_centroidal_mpc
    mpc = build(*mpc_files(ASSETS / "humanoid23", form), n_nodes=6, device=card)
    return mpc.model, np.asarray(mpc.initial_state, dtype=np.float64)


def _policy(model, x0, seed):
    from wb_humanoid_mpc_tpu_torch.mpc.runtime import Policy

    rng = np.random.default_rng(seed)
    n = 5
    return Policy(t0=0.0, dt=0.04, xs=x0 + 0.02 * rng.standard_normal((n, x0.size)),
                  us=rng.standard_normal((n - 1, model.layout.input_dim)),
                  contact_flags=np.ones((n, 2)))


@pytest.mark.parametrize("form", ["wb", "centroidal"])
def test_graphed_controller_matches_eager_on_the_card(card, form):
    """The MRT controller as a user gets it on the card (its feed-forward
    one CUDA graph, captured at the first compute, on its own stream)
    against its eager twin (`graphs=False`) on the same
    observations, the fallback and a policy: within GRAPH_TOL x max(1,
    max|ref|) (the maximum is printed; expected 0)."""
    from wb_humanoid_mpc_tpu_torch.mpc.controller import (
        CentroidalMrtController,
        WBMrtController,
    )

    cls = WBMrtController if form == "wb" else CentroidalMrtController
    model, x0 = _h23_model(card, form)
    graphed, eager = cls(model, device=card), cls(model, device=card, graphs=False)
    assert graphed.graph is not None and eager.graph is None
    assert graphed.stream != torch.cuda.current_stream(card)
    pol = _policy(model, x0, 1)
    rng = np.random.default_rng(2)
    worst = 0.0
    for t in (0.0, 0.013, 0.05, 0.5):
        x = pol.evaluate(t)[0] + 0.01 * rng.standard_normal(x0.shape)
        for policy in (None, pol):
            err, limit = _scaled(graphed.compute(t, x, policy).ff_effort,
                                 eager.compute(t, x, policy).ff_effort)
            assert err <= limit, f"{form} t={t}: {err:.3e} > {limit:.3e}"
            worst = max(worst, err)
    (entry,) = graphed.graph.entries.values()
    assert list(entry.graphs) == [entry.pieces[0].name]
    print(f"{form} controller graphed vs eager: max|d| {worst:.3e}")


@pytest.mark.parametrize("form", ["wb", "centroidal"])
def test_graphed_plant_step_matches_eager_on_the_card(card, form):
    """The dummy plant's RK4 step graphed (its default on the card) against
    its eager twin, on a flow that reads t (the model's + 0.05 sin(t)): the
    same within GRAPH_TOL x max(1, max|ref|) at t = 0, 0.3, 0.9 after a
    capture at 0, and the same (x, u) at another t moves the result."""
    from wb_humanoid_mpc_tpu_torch.sim.dummy import PlantStep

    model, x0 = _h23_model(card, form)

    def flow(t, x, u):
        return model.flow_map(t, x, u) + 0.05 * torch.sin(t)

    graphed = PlantStep(flow, 0.02, card, torch.float32)
    eager = PlantStep(flow, 0.02, card, torch.float32, graphs=False)
    assert graphed.graph is not None and eager.graph is None
    rng = np.random.default_rng(3)
    x, u = x0 + 0.02 * rng.standard_normal(x0.size), rng.standard_normal(model.layout.input_dim)
    outs = []
    for t in (0.0, 0.3, 0.9):
        got = graphed(t, x, u)
        err, limit = _scaled(got, eager(t, x, u))
        assert err <= limit, f"{form} t={t}: {err:.3e} > {limit:.3e}"
        outs.append(got)
        print(f"{form} plant step t={t}: graphed vs eager {err:.3e}")
    assert np.abs(outs[2] - outs[0]).max() > 1e-4


def test_graphed_staged_solver_matches_eager_on_the_card(card):
    """`make_staged_sqp_solver` on the card replays one graph a phase; on a
    time-dependent OCP (humanoid23, N = 28, f32, two iterations a call),
    calls at t0 = 0, 0.4, 0.8 from the same start equal the eager staged
    solve within GRAPH_TOL x max(1, max|ref|) with the same step, K1 and K2
    launch as often graphed as eager (K1 once an iteration), the four phase
    times are positive, and t0 moves the answer."""
    from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedStagedSolve
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_staged_sqp_solver

    pb = build_wb_problem(ASSETS / "humanoid23", 28, device=card, dtype=torch.float32)
    ocp = type("TimedWholeBodyOcp", (_TimedOcp, WholeBodyOcp), {})(model=pb.model, cfg=pb.cfg)
    cfg = SqpSolverConfig(n_nodes=28, dt=pb.cfg.sqp.dt, sqp_iterations=2)
    graphed = make_staged_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device=card)
    eager = make_staged_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device=card,
                                   graphs=False)
    assert isinstance(graphed, GraphedStagedSolve) and not isinstance(eager, GraphedStagedSolve)
    sols, counts = {}, {}
    for name, solve in (("graphed", graphed), ("eager", eager)):
        riccati.reset_launches()
        fkvel.reset_launches()
        sols[name] = [solve(t0, pb.x0, pb.traj, pb.params, pb.lam) for t0 in (0.0, 0.4, 0.8)]
        torch.cuda.synchronize()
        counts[name] = (riccati.LAUNCHES, fkvel.LAUNCHES)
    assert counts["graphed"] == counts["eager"] and counts["graphed"][0] == 6, counts
    for k, ((got, phases), (ref, _)) in enumerate(zip(sols["graphed"], sols["eager"])):
        for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us),
                           ("cost", got.cost, ref.cost)):
            err, limit = _scaled(a, b)
            assert err <= limit, f"call {k} {what}: {err:.3e} > {limit:.3e}"
        assert float(got.step_size) == float(ref.step_size)
        assert min(phases) > 0.0
        print(f"staged call {k}: phases {dict(phases._asdict())}")
    assert _moved(sols["graphed"][0][0], sols["graphed"][2][0]) > 1e-4


def test_graphed_staged_solver_first_call_at_one_iteration(card):
    """The first call of a graphed staged solver at one SQP iteration a call
    (the default) runs that iteration eagerly and then only captures: its
    trajectory, cost, g_norm, defect norm and step equal the eager staged
    solve's within GRAPH_TOL x max(1, max|ref|), as do the next call's,
    which replays."""
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_staged_sqp_solver

    pb = build_wb_problem(ASSETS / "humanoid23", 28, device=card, dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=28, dt=pb.cfg.sqp.dt)
    assert cfg.sqp_iterations == 1
    graphed = make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=card)
    eager = make_staged_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device=card,
                                   graphs=False)
    traj = pb.traj
    for k in range(2):
        got, ref = (solve(0.1 * k, pb.x0, traj, pb.params, pb.lam)[0]
                    for solve in (graphed, eager))
        for what, a, b in (("xs", got.traj.xs, ref.traj.xs), ("us", got.traj.us, ref.traj.us),
                           ("cost", got.cost, ref.cost), ("g_norm", got.g_norm, ref.g_norm),
                           ("defect_norm", got.defect_norm, ref.defect_norm)):
            err, limit = _scaled(a, b)
            assert err <= limit, f"call {k} {what}: {err:.3e} > {limit:.3e}"
        assert float(got.step_size) == float(ref.step_size), f"call {k}"
        traj = got.traj
    (s,) = graphed.sets.values()
    assert len(s.graphs) == 4


def test_controller_and_solve_capture_in_two_threads(card):
    """Controllers capture and replay their graphs in this thread while
    another thread captures and replays a graphed solve (thread-local
    capture: neither refuses the other's work); every torque and solution
    equals its eager twin's within GRAPH_TOL x max(1, max|ref|)."""
    import threading

    from wb_humanoid_mpc_tpu_torch.mpc.controller import WBMrtController

    pb, graphed, eager = _graphed_and_eager(card, 28, sqp_iterations=1)
    start = threading.Barrier(2)
    solves, errors = [], []

    def solver():
        try:
            start.wait(timeout=60)
            traj, lam = pb.traj, pb.lam
            for _ in range(6):
                sol = graphed(0.0, pb.x0, traj, pb.params, lam)
                solves.append((traj, lam, sol))
                traj, lam = sol.traj, sol.lam
        except BaseException as e:   # handed to the main thread
            errors.append(e)

    thread = threading.Thread(target=solver, name="solver")
    thread.start()
    start.wait(timeout=60)
    x0 = pb.x0.double().cpu().numpy()
    pol = _policy(pb.model, x0, 4)
    ctrls = [WBMrtController(pb.model, device=card) for _ in range(3)]
    taus = [[c.compute(0.002 * k, x0, pol).ff_effort for k in range(30)] for c in ctrls]
    thread.join(timeout=600)
    assert not thread.is_alive() and not errors, errors
    twin = WBMrtController(pb.model, device=card, graphs=False)
    for c_taus in taus:
        for k, tau in enumerate(c_taus):
            err, limit = _scaled(tau, twin.compute(0.002 * k, x0, pol).ff_effort)
            assert err <= limit, f"tick {k}: {err:.3e} > {limit:.3e}"
    assert len(solves) == 6
    for traj, lam, sol in solves:
        ref = eager(0.0, pb.x0, traj, pb.params, lam)
        for a, b in ((sol.traj.xs, ref.traj.xs), (sol.traj.us, ref.traj.us)):
            err, limit = _scaled(a, b)
            assert err <= limit, f"{err:.3e} > {limit:.3e}"


def test_controller_capture_failure_raises(card, monkeypatch):
    """An operation that reads the device inside the feed-forward (here
    `.item()`) makes the controller's capture fail: compute raises, naming
    the operation, and computes nothing eagerly instead."""
    from wb_humanoid_mpc_tpu_torch.mpc.controller import WBMrtController

    model, x0 = _h23_model(card, "wb")
    orig = type(model).joint_torques

    def reads_the_device(self, x, u):
        if float(x.abs().max().item()) < 0:
            raise AssertionError("unreachable")
        return orig(self, x, u)

    monkeypatch.setattr(type(model), "joint_torques", reads_the_device)
    ctrl = WBMrtController(model, device=card)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the whole-body MRT "
                                           "controller's feed-forward failed at "
                                           ".*reads_the_device"):
        ctrl.compute(0.0, x0, None)
    (entry,) = ctrl.graph.entries.values()
    assert not entry.graphs
    torch.cuda.synchronize()


def _spinner(card):
    """A graphed function whose graph spins one thread of the card for
    `cycles` clock cycles (its piece, and so its replay spans, named
    `spinner`) and the input it runs on, captured outside any record."""
    from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

    def fn(x, cycles):
        torch.cuda._sleep(cycles)
        return x + 1

    x = torch.zeros(4, device=card)
    graphs = {}

    def run(cycles: int):
        if cycles not in graphs:
            graphs[cycles] = GraphedFunction(lambda a: fn(a, cycles), card, "spinner")
            graphs[cycles].run(x)
            torch.cuda.synchronize()
        graphs[cycles].run(x)

    return run, x


def _trace_readback(x):
    """The end of `MpcRuntime.advance` in small: a `readback` span of two
    synchronous copies with the record's anchor, the end of its device
    pair, between them."""
    from wb_humanoid_mpc_tpu_torch.utils import trace

    with trace.span("readback"):
        trace.device_start("download")
        y = x.double().cpu()
        trace.device_end("download", anchor=True)
        return y, x.double().cpu()


@pytest.mark.parametrize("cycles", [1_000, 1_000_000], ids=["short", "1ms"])
def test_trace_places_idle_on_the_host_span_that_held_it(card, cycles, monkeypatch):
    """A replay of a graph (a few microseconds, or about 0.5-1 ms of
    spinning), a span in which the host waits for it, a 2 ms host sleep in
    a span, a second replay. The recorder gives the sleeping span, when
    the card has nothing to do, its whole duration as idle time, within
    50 us. It places the first replay's start no earlier than 50 us
    before the host's span that launched it, its end no later than 50 us
    after the host's return from the wait, and, where the card was still
    busy when the host began to wait (the long graph, so that the wait
    returns as the replay ends), within 50 us of that return (the short
    graph ends before the host begins to wait); five records after one
    that is not judged (the first after a capture has placed its events
    up to 60 us late), all printed before any is judged."""
    import time

    from wb_humanoid_mpc_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "DEVICE_EVERY", 1)
    run, x = _spinner(card)
    run(cycles)
    rows = []
    for _ in range(6):
        torch.cuda.synchronize()
        o = trace.begin(card)
        run(cycles)
        with trace.span("wait"):
            torch.cuda.current_stream().synchronize()
        with trace.span("host_sleep"):
            time.sleep(0.002)
        run(cycles)
        _trace_readback(x)
        rec = trace.end(o, 0, False)
        spans = {s.name: s for s in rec.spans if s.name != "spinner"}
        iv = [i for i in rec.device if i.name == "spinner"]
        assert len(iv) == 2 and rec.replays == {"spinner": 2}
        wait, sleep = spans["wait"], spans["host_sleep"]
        launch = next(s for s in rec.spans if s.name == "spinner")
        rows.append(((iv[0].end_ns - wait.end_ns) * 1e-3, sleep.seconds,
                     rec.idle_s["host_sleep"], (iv[0].start_ns - launch.start_ns) * 1e-3))
        at = rec.advance.start_ns

        def us(rows):
            return [(r.name, round((r.start_ns - at) * 1e-3, 1), round((r.end_ns - at) * 1e-3, 1))
                    for r in rows]

        print(f"cycles {cycles}: intervals (us from advance) {us(rec.device)}; "
              f"spans {us(rec.spans)}")
    for end_us, sleep_s, idle_s, start_us in rows:
        print(f"cycles {cycles}: replay placed to end {end_us:+.1f} us from the wait's return, "
              f"to start {start_us:+.1f} us from its launch's span; "
              f"sleep span {sleep_s * 1e3:.4f} ms, idle in it {idle_s * 1e3:.4f} ms")
    for end_us, sleep_s, idle_s, start_us in rows[1:]:
        assert sleep_s >= 0.002
        assert end_us <= 50.0 and (cycles < 1_000_000 or end_us >= -50.0)
        assert start_us >= -50.0
        assert abs(idle_s - sleep_s) <= 50e-6


def test_trace_replay_times_match_replay_events(card, monkeypatch):
    """Each replay's device time in the record agrees within 2 % with a pair
    of CUDA events recorded around `CUDAGraph.replay` itself (the
    benchmark's `ReplayTimer`), over 8 replays of a 0.5-1 ms graph queued
    behind a spinning kernel, so that both pairs time the card's work and
    not the host's launches in between."""
    from wb_humanoid_mpc_tpu_torch.utils import trace

    run, x = _spinner(card)
    run(1_000_000)
    pairs = []
    orig = torch.cuda.CUDAGraph.replay

    def replay(graph):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        orig(graph)
        b.record()
        pairs.append((a, b))

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    monkeypatch.setattr(trace, "DEVICE_EVERY", 1)
    torch.cuda.synchronize()
    o = trace.begin(card)
    torch.cuda._sleep(20_000_000)
    for _ in range(8):
        run(1_000_000)
    _trace_readback(x)
    rec = trace.end(o, 0, False)
    got = [(i.end_ns - i.start_ns) * 1e-6 for i in rec.device if i.name == "spinner"]
    ref = [a.elapsed_time(b) for a, b in pairs]
    print("recorder ms", [f"{v:.4f}" for v in got], "events ms", [f"{v:.4f}" for v in ref])
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert abs(g - r) <= 0.02 * r


# ---- the centroidal node params as one graph (`interface.build_centroidal_mpc`) ----

def _h23_centroidal(card, n_nodes=60):
    from wb_humanoid_mpc_tpu_torch.interface import build_centroidal_mpc, mpc_files

    return build_centroidal_mpc(*mpc_files(ASSETS / "humanoid23", "centroidal"),
                                n_nodes=n_nodes, device=card)


def _params_graph(mpc):
    """The `GraphedFunction` that the runtime's `make_node_params` replays."""
    from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

    (graph,) = [c.cell_contents for c in mpc.runtime.make_node_params.__closure__
                if isinstance(c.cell_contents, GraphedFunction)]
    return graph


def _params_refs(mpc, seed):
    """Seeded target states about the initial state, under a walking
    schedule, in the form `make_node_params` takes."""
    import types

    from wb_humanoid_mpc_tpu_torch.interface import walking_reference

    rng = np.random.default_rng(seed)
    x0 = np.asarray(mpc.initial_state, dtype=np.float64)
    return types.SimpleNamespace(swing=walking_reference(mpc.n_nodes),
                                 x_ref=x0 + 0.05 * rng.standard_normal((mpc.n_nodes + 1,
                                                                        x0.size)))


def _params_against_eager(mpc, refs, card) -> list:
    """The runtime's params (a replay) against `make_centroidal_node_params`
    eagerly on the card, leaf by leaf: [(max |d|, limit)]; the replayed
    leaves are cloned first, since the next replay overwrites them."""
    from wb_humanoid_mpc_tpu_torch.ocp.params import make_centroidal_node_params

    got = [a.clone() for a in mpc.runtime.make_node_params(refs)]
    ref = make_centroidal_node_params(mpc.ocp, refs.swing,
                                      torch.as_tensor(refs.x_ref, dtype=torch.float32,
                                                      device=card))
    assert len(got) == len(ref) == 7
    return [_scaled(a, b) for a, b in zip(got, ref)], got


def test_graphed_params_match_eager_on_the_card(card):
    """humanoid23 centroidal at N = 60, f32: the node params replayed from
    their CUDA graph (captured at the first call) equal
    `make_centroidal_node_params` run eagerly within GRAPH_TOL x max(1,
    max|ref|) on four ticks of other target states, and each tick's leaves
    differ from the last's (the inputs are read at every replay, not baked
    into the graph)."""
    mpc = _h23_centroidal(card)
    last, worst = None, 0.0
    for seed in range(4):
        rows, got = _params_against_eager(mpc, _params_refs(mpc, seed), card)
        for (err, limit), name in zip(rows, ("contact", "z_pos", "z_vel", "proximity", "x_ref",
                                             "u_ref", "torso_ref")):
            assert err <= limit, f"tick {seed} {name}: {err:.3e} > {limit:.3e}"
            worst = max(worst, err)
        if last is not None:
            assert not torch.equal(got[4], last[4]) and not torch.equal(got[6], last[6])
        last = got
    (entry,) = _params_graph(mpc).entries.values()
    assert list(entry.graphs) == ["params (the centroidal node params)"]
    print(f"params graphed vs eager: max|d| {worst:.3e}")


def test_graphed_params_survive_a_gain_update(card):
    """A gain update rebuilds the solves and keeps the params' graph (the
    params read the robot and the task-space links, not the gains): after
    it, the replayed params still equal `make_centroidal_node_params`."""
    from wb_humanoid_mpc_tpu_torch.mpc.gains import GainUpdate

    mpc = _h23_centroidal(card, n_nodes=6)
    rt = mpc.runtime
    rt.advance(0.0, np.asarray(mpc.initial_state, dtype=float), np.zeros(4))
    graph = _params_graph(mpc)
    (entry,) = graph.entries.values()
    captured = dict(entry.graphs)
    mpc.gains.apply(GainUpdate(term="Q", values=2.0 * np.asarray(mpc.cfg.Q)))
    for seed in range(2):
        rows, _ = _params_against_eager(mpc, _params_refs(mpc, 10 + seed), card)
        for err, limit in rows:
            assert err <= limit, f"{err:.3e} > {limit:.3e}"
    assert list(graph.entries.values()) == [entry] and entry.graphs == captured


def test_trace_holds_one_params_replay_in_refs(card, monkeypatch):
    """Inside an open trace record, each `advance` of the centroidal MPC
    replays the params' graph once: one `params` span, inside `refs`,
    `replays["params"] == 1`; the upload's device pair lies inside `refs`
    and the replay's starts there (it may end after the host has left
    `refs`: the host does not wait for it), every record timing the
    device."""
    from wb_humanoid_mpc_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "DEVICE_EVERY", 1)
    mpc = _h23_centroidal(card, n_nodes=6)
    rt = mpc.runtime
    x = np.asarray(mpc.initial_state, dtype=float)
    records = []
    for k in range(4):
        records.append(rt.advance(0.0125 * k, x, np.zeros(4)).trace)
        x = np.asarray(rt.policy.evaluate(0.0125 * (k + 1))[0], dtype=float)
    for rec in records:
        names = [s.name for s in rec.spans]
        assert names.count("params") == 1 and rec.replays["params"] == 1
        refs = next(s for s in rec.spans if s.name == "refs")
        params = next(s for s in rec.spans if s.name == "params")
        assert rec.spans[params.parent].name == "refs"
        device = {iv.name: iv for iv in rec.device}
        upload, replay = device["params_upload"], device["params"]
        assert refs.start_ns <= upload.start_ns <= upload.end_ns <= refs.end_ns + 50_000
        assert upload.end_ns <= replay.start_ns + 50_000
        assert refs.start_ns <= replay.start_ns <= replay.end_ns
        assert replay.start_ns <= refs.end_ns + 50_000
        print(f"refs {refs.seconds * 1e3:.3f} ms: params replay device "
              f"{(device['params'].end_ns - device['params'].start_ns) * 1e-3:.1f} us, "
              f"idle in refs {rec.idle_s.get('refs', 0.0) * 1e3:.3f} ms")


def test_saved_wb_walk_solve_matches_the_reference_on_the_card(card):
    """The benchmark's whole-body solve that the port once answered 4.3e-2
    from float64 (`tests/_saved_solve.py`: seed 2147490101, episode 2, step
    77), through the program's own path: `build_wb_mpc`'s graphed solve in
    float32 (K1, K2 and the CUDA graphs; the first call captures, the later
    ones replay), and its eager twin, each within the benchmark's limit of
    the plain reference in float64."""
    from pathlib import Path

    from mpcbench import compare, harness
    from wb_humanoid_mpc_tpu_torch import interface
    from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams
    from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
    from wb_humanoid_mpc_tpu_torch.solver.sqp import make_sqp_solver
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    # by its path: with --noconftest another installed package may own the
    # name `tests`
    saved = harness.load_module(Path(__file__).with_name("_saved_solve.py"), "saved_solve")
    ref = saved.reference_answer(card)
    mpc = interface.build_wb_mpc(*saved.files(saved.cell()), device=card, dtype=torch.float32)
    graphed = mpc.runtime.solve_fn
    assert isinstance(graphed, GraphedSqpSolve) and graphed.iterations == saved.iterations()
    args = saved.inputs(Trajectory, WBNodeParams, torch.float32, card)
    limit = compare.LIMITS["policy_gap_max"]
    fkvel.reset_launches()
    for call in range(3):
        gap = saved.gap(graphed(*args), ref)
        print(f"graphed call {call}: gap {gap:.3e}")
        assert gap < limit, call
    # every K2 launch of the graphed solve is the flow variant
    assert fkvel.FLOW_LAUNCHES == fkvel.LAUNCHES > 0, (fkvel.FLOW_LAUNCHES, fkvel.LAUNCHES)
    eager = make_sqp_solver(mpc.ocp, mpc.model.flow_map,
                            mpc.ocp.barrier_params(card, torch.float32), graphed.it.cfg,
                            device=card, graphs=False)
    gap = saved.gap(eager(*args), ref)
    print(f"eager: gap {gap:.3e}")
    assert gap < limit
