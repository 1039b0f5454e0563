"""PyTorch port, the batched SQP solve (`parallel/batched.py`, the leading
batch axis through `solver/`) on toy_biped (stance, N = 6, f64, two SQP
iterations):

- a B = 3 batched solve against JAX's `make_batched_solver` (`vmap` of the
  solve) on the same seeded perturbed x0, for projection + filter and for
  AL + merit: xs, us, multipliers, cost and g_norm per instance within
  1e-8 max(1, max|ref|), the same step per instance. The third instance
  starts ten times farther off, so that on the filter path it accepts
  neither top step and takes the lower ladder while the other two take the
  full step: the per-instance select of JAX's `lax.cond` under `vmap`;
- the batched port against the unbatched port, instance by instance (and
  the parallel-Riccati and exact-sensitivity paths the same way);
- kernel launches: the CUDA wrappers replaced by their plain versions that
  still count, K1 launches once per batched SQP iteration and K2 as often
  as in one unbatched solve (3 for the RK4 tail, 3 for the top-2 sweep, 3
  more when some instance needs the lower ladder), whatever B is."""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import NO_BATCHING_FALLBACK, jax_wb, port_problem, to_numpy
from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
from wb_humanoid_mpc_tpu.parallel.batched import make_batched_solver as jax_make_batched
from wb_humanoid_mpc_tpu.refs.swing import SwingReference
from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig as JaxConfig
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.ops import fkvel, riccati
from wb_humanoid_mpc_tpu_torch.parallel import scaling
from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_throughput
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

N = 6
ITERS = 2
B = 3
SPREAD = np.array([0.005, 0.005, 0.05])   # the third instance needs the lower ladder
BATCH_TOL = 1e-8
CONFIGS = {"filter": {}, "al_merit": dict(equality_handling="al", line_search="merit")}


def _noise(nx: int):
    return np.random.default_rng(0).standard_normal((B, nx)) * SPREAD[:, None]


def _jax_batched(fields):
    """JAX's vmapped solve of the B perturbed stance problems, as numpy."""
    cfg, model, ocp = jax_wb("toy_biped")
    ref = interface.stance_reference(N)
    swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos, z_vel=ref.z_vel,
                           z_acc=ref.z_acc, proximity=ref.proximity)
    x0 = jnp.asarray(cfg.initial_state, dtype=jnp.float64)
    params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
    u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity, jnp.ones(2),
                           model.layout.input_dim)
    solve = jax_make_batched(ocp, model.flow_map, ocp.barrier_params(),
                             JaxConfig(n_nodes=N, dt=cfg.sqp.dt, sqp_iterations=ITERS, **fields))
    x0s = x0 + jnp.asarray(_noise(x0.shape[0]))
    init = JaxTrajectory(xs=jnp.tile(x0, (B, N + 1, 1)), us=jnp.tile(u0, (B, N, 1)))
    paramsB = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), params)
    sol = solve(0.0, x0s, init, paramsB, jnp.zeros((B, N, ocp.n_eq)))
    return to_numpy((sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.step_size))


def _port_inputs(pb):
    x0s = pb.x0 + torch.as_tensor(_noise(pb.x0.shape[0]), dtype=pb.x0.dtype)

    def rep(a):
        return a.expand(B, *a.shape).contiguous()

    return (x0s, Trajectory(xs=rep(pb.traj.xs), us=rep(pb.traj.us)),
            type(pb.params)(*(rep(a) for a in pb.params)), rep(pb.lam))


def _port_batched(fields, **solver_fields):
    pb = port_problem("stance", N, "f64")
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=ITERS, **fields,
                          **solver_fields)
    solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
    return pb, cfg, solve(0.0, *_port_inputs(pb))


def _assert_instances_close(got, ref, what):
    """got, ref: (xs, us, lam, cost, g_norm, step) with a leading B."""
    for name, a, b in zip(("xs", "us", "lam", "cost", "g_norm"), got[:5], ref[:5]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, f"{what} {name}: {a.shape} vs {b.shape}"
        for i in range(B):
            limit = BATCH_TOL * max(1.0, float(np.abs(b[i]).max()))
            err = float(np.abs(a[i] - b[i]).max())
            assert err <= limit, f"{what} {name} instance {i}: {err:.3e} > {limit:.3e}"
    np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(ref[5]), err_msg=what)


def _sol_tuple(sol):
    return to_numpy((sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.step_size))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_batched_solve_matches_jax(config):
    ref = _jax_batched(CONFIGS[config])
    _, _, sol = _port_batched(CONFIGS[config])
    got = _sol_tuple(sol)
    _assert_instances_close(got, ref, f"B={B} {config}")
    steps = got[5]
    if config == "filter":
        # instances 0 and 1 take a top-2 step, instance 2 one of the lower ladder
        assert steps[0] in (1.0, 0.7) and steps[1] in (1.0, 0.7), steps
        assert 0.0 < steps[2] < 0.7, steps


@pytest.mark.parametrize("config,extra", [("filter", {}), ("al_merit", {}),
                                          ("filter", dict(parallel_riccati=True)),
                                          ("filter", dict(sensitivity="exact"))],
                         ids=["filter", "al_merit", "parallel_riccati", "exact"])
def test_batched_matches_unbatched(config, extra):
    pb, cfg, sol = _port_batched(CONFIGS[config], **extra)
    x0s, traj, params, lam = _port_inputs(pb)
    single = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
    refs = []
    for i in range(B):
        s = single(0.0, x0s[i], Trajectory(xs=traj.xs[i], us=traj.us[i]),
                   type(params)(*(a[i] for a in params)), lam[i])
        assert s.cost.shape == ()
        refs.append(_sol_tuple(s))
    ref = [np.stack([r[k] for r in refs]) for k in range(6)]
    _assert_instances_close(_sol_tuple(sol), ref, f"batched vs unbatched {config} {extra}")


@pytest.fixture
def counting_kernels(monkeypatch):
    """The CUDA wrappers replaced by their plain versions, still counting."""
    def k1(*args, **kwargs):
        riccati.LAUNCHES += 1
        return riccati.riccati_rollout_plain(*args, **kwargs)

    def k2(*args, **kwargs):
        fkvel.LAUNCHES += 1
        return fkvel.fkvel_plain(*args, **kwargs)

    monkeypatch.setattr(riccati, "riccati_rollout_cuda", k1)
    monkeypatch.setattr(fkvel, "fkvel_cuda", k2)
    riccati.reset_launches()
    fkvel.reset_launches()
    yield
    riccati.reset_launches()
    fkvel.reset_launches()


@pytest.mark.parametrize("instances,k2_expected", [((0,), 12), ((2,), 18), ((0, 1), 12),
                                                   ((0, 1, 2), 18)],
                         ids=["one_top", "one_low", "two_top", "three_mixed"])
def test_launches_do_not_grow_with_the_batch(counting_kernels, instances, k2_expected):
    """Two SQP iterations: K1 twice; K2 6 an iteration, 9 when an instance of
    the batch needs the lower ladder (instance 2 in both iterations)."""
    pb = port_problem("stance", N, "f64")
    cfg = SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, sqp_iterations=ITERS,
                          rollout_backend="cuda", flow_backend="cuda")
    x0s, traj, params, lam = _port_inputs(pb)
    sel = list(instances)
    if len(sel) == 1:
        i = sel[0]
        solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
        sol = solve(0.0, x0s[i], Trajectory(xs=traj.xs[i], us=traj.us[i]),
                    type(params)(*(a[i] for a in params)), lam[i])
    else:
        solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
        sol = solve(0.0, x0s[sel], Trajectory(xs=traj.xs[sel], us=traj.us[sel]),
                    type(params)(*(a[sel] for a in params)), lam[sel])
    assert bool(torch.isfinite(sol.cost).all())
    assert (riccati.LAUNCHES, fkvel.LAUNCHES) == (ITERS, k2_expected)


def test_batched_solver_refuses_bad_shapes():
    pb = port_problem("stance", N, "f64")
    solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp,
                                SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt), device="cpu")
    x0s, traj, params, lam = _port_inputs(pb)
    with pytest.raises(ValueError, match="x0"):
        solve(0.0, x0s[0], traj, params, lam)
    with pytest.raises(ValueError, match="lam"):
        solve(0.0, x0s, traj, params, lam[:2])


def test_batched_throughput_on_the_cpu():
    out = batched_throughput(2, n_nodes=3, n_rounds=1, device="cpu", dtype=torch.float64)
    assert out["batch"] == 2 and out["finite"] and out["device"] == "cpu"
    assert out["instances_per_s"] == 2 / out["round_time_s"]


def test_batched_throughput_takes_the_solver_overrides(monkeypatch):
    """`solver_overrides` reach `SqpSolverConfig` (JAX's argument); the
    whole-body problem is solved whatever `formulation` says; the rate counts
    every SQP iteration of a solve."""
    seen = []
    real = scaling.SqpSolverConfig

    def recording(**kw):
        seen.append(real(**kw))
        return seen[-1]

    monkeypatch.setattr(scaling, "SqpSolverConfig", recording)
    out = batched_throughput(2, 3, "centroidal", 1, 0, {"sqp_iterations": 2, "rho": 500.0},
                             device="cpu", dtype=torch.float64)
    assert [(c.sqp_iterations, c.rho) for c in seen] == [(2, 500.0)]
    assert out["finite"]
    assert out["sqp_iterations_per_s"] == 2 * 2 / out["round_time_s"]


def test_scaling_report_records_a_failed_point_and_stops(monkeypatch):
    """A point that raises is recorded with its error's first line (at most
    200 characters) and ends the sweep, as JAX's report does."""
    calls = []

    def fake(batch, n_nodes, solver_overrides=None, *, device, dtype):
        calls.append((batch, solver_overrides))
        if batch == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. " + "x" * 300 + "\nmore")
        return {"batch": batch, "n_nodes": n_nodes, "finite": True}

    monkeypatch.setattr(scaling, "batched_throughput", fake)
    out = scaling.scaling_report((2, 3, 4), n_nodes=3, solver_overrides={"rho": 500.0},
                                 device="cpu", dtype=torch.float64)
    assert calls == [(2, {"rho": 500.0}), (3, {"rho": 500.0})]
    assert out[0] == {"batch": 2, "n_nodes": 3, "finite": True}
    assert out[1] == {"batch": 3, "n_nodes": 3,
                      "error": ("CUDA out of memory. " + "x" * 300)[:200]}
    assert len(out) == 2


def test_scaling_report_on_the_cpu():
    out = scaling.scaling_report((2, 3), n_nodes=3, solver_overrides={}, device="cpu",
                                 dtype=torch.float64)
    assert [r["batch"] for r in out] == [2, 3] and all(r["finite"] for r in out)
    assert inspect.signature(scaling.scaling_report).parameters["batches"].default == (
        1, 8, 64, 256, 1024)
