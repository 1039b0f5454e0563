"""Shared helpers of the PyTorch port's equivalence tests (tests/test_torch_*.py).

Both packages get the same numpy inputs, made from a seed; the JAX function
and its counterpart in `wb_humanoid_mpc_tpu_torch` run on the CPU and their
outputs are compared at a stated tolerance. tests/conftest.py turns JAX x64
on, so float32 cases hand JAX explicit float32 arrays, and `x64_off()` runs a
JAX reference in pure float32 (as on the TPU) where constants inside the JAX
code would otherwise promote it to float64. Robots come from the port's
committed assets (`wb_humanoid_mpc_tpu_torch/assets/`), loaded by each
package through its own public API; nothing here reads `/root/reference`.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wb_humanoid_mpc_tpu.core.config import load_task_config
from wb_humanoid_mpc_tpu.models.layout import WBLayout
from wb_humanoid_mpc_tpu.models.robot.factory import build_robot_model, mpc_joint_names
from wb_humanoid_mpc_tpu.models.wb_model import WholeBodyModel
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WholeBodyOcp
from wb_humanoid_mpc_tpu_torch import interface as port_interface
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp as PortWholeBodyOcp

# the suite runs under pytest-xdist with several workers
torch.set_num_threads(1)

# functorch warns "There is a performance drop because we have not yet
# implemented the batching rule for ..." when an op has no batching rule and
# it falls back to a per-tangent Python loop; the tests turn that into an error
NO_BATCHING_FALLBACK = "error:.*performance drop:UserWarning"

ASSETS = port_interface.ASSETS
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@contextlib.contextmanager
def x64_off():
    """Run JAX in float32 mode (the TPU's), restoring x64 afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def jax_mode(dtype: str):
    """Context for a JAX reference in `dtype`: x64 as the suite has it for
    f64, pure float32 for f32."""
    return contextlib.nullcontext() if dtype == "f64" else x64_off()


@functools.lru_cache(maxsize=None)
def jax_wb(robot: str):
    """(cfg, model, ocp) of the JAX package for an asset robot."""
    urdf, task = port_interface.asset_files(ASSETS / robot)
    probe = load_task_config(task, "wb", 1, 1)
    layout = WBLayout(n_joints=len(mpc_joint_names(urdf, probe.model_settings.fixed_joint_names)))
    cfg = load_task_config(task, "wb", layout.state_dim, layout.input_dim)
    model = WholeBodyModel(robot=build_robot_model(urdf, cfg), layout=layout,
                           contact_frames=tuple(cfg.model_settings.contact_names))
    return cfg, model, WholeBodyOcp(model=model, cfg=cfg)


@functools.lru_cache(maxsize=None)
def port_wb(robot: str):
    """(cfg, model, ocp) of the PyTorch port for an asset robot."""
    cfg, model = port_interface.load_wb_model(ASSETS / robot)
    return cfg, model, PortWholeBodyOcp(model=model, cfg=cfg)


def _centroidal_setup(load_task, layout_cls, build_robot, mpc_joint_names_, load_ref,
                      model_cls, ocp_cls, robot: str, srbm: bool):
    urdf, task, ref, _ = port_interface.mpc_files(ASSETS / robot, "centroidal")
    probe = load_task(task, "centroidal", 1, 1)
    layout = layout_cls(n_joints=len(mpc_joint_names_(urdf,
                                                      probe.model_settings.fixed_joint_names)))
    cfg = load_task(task, "centroidal", layout.state_dim, layout.input_dim)
    model = model_cls(robot=build_robot(urdf, cfg), layout=layout,
                      contact_frames=tuple(cfg.model_settings.contact_names), srbm=srbm,
                      nominal_joint_angles=tuple(
                          load_ref(ref, layout.n_joints).default_joint_state.tolist()))
    return cfg, model, ocp_cls(model=model, cfg=cfg)


@functools.lru_cache(maxsize=None)
def jax_centroidal(robot: str, srbm: bool = False):
    """(cfg, model, ocp) of the JAX centroidal formulation for an asset
    robot, built as `build_centroidal_mpc` builds them."""
    from wb_humanoid_mpc_tpu.core.config import load_reference_config
    from wb_humanoid_mpc_tpu.models.centroidal_model import CentroidalModel
    from wb_humanoid_mpc_tpu.models.layout import CentroidalLayout
    from wb_humanoid_mpc_tpu.ocp.centroidal_ocp import CentroidalOcp

    return _centroidal_setup(load_task_config, CentroidalLayout, build_robot_model,
                             mpc_joint_names, load_reference_config, CentroidalModel,
                             CentroidalOcp, robot, srbm)


@functools.lru_cache(maxsize=None)
def port_centroidal(robot: str, srbm: bool = False):
    """(cfg, model, ocp) of the port's centroidal formulation."""
    from wb_humanoid_mpc_tpu_torch.core import config as pc
    from wb_humanoid_mpc_tpu_torch.models.centroidal_model import CentroidalModel
    from wb_humanoid_mpc_tpu_torch.models.layout import CentroidalLayout
    from wb_humanoid_mpc_tpu_torch.models.robot import factory as pf
    from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import CentroidalOcp

    return _centroidal_setup(pc.load_task_config, CentroidalLayout, pf.build_robot_model,
                             pf.mpc_joint_names, pc.load_reference_config, CentroidalModel,
                             CentroidalOcp, robot, srbm)


def to_numpy(tree):
    """Nested tuples/lists/NamedTuples of jax arrays or torch tensors -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return [to_numpy(t) for t in tree]
    return np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def assert_close(got, ref, *, rtol: float, atol: float, what: str = "") -> float:
    """Compare two trees leaf by leaf; returns the largest |got - ref|."""
    g, r = _leaves(to_numpy(got)), _leaves(to_numpy(ref))
    assert len(g) == len(r), f"{what}: {len(g)} outputs vs {len(r)}"
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, r)):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        np.testing.assert_allclose(a, np.broadcast_to(b, a.shape), rtol=rtol, atol=atol,
                                   err_msg=f"{what} output {i}")
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def check_pair(seed: int, make_inputs, jax_fn, port_fn, dtype: str, *, rtol: float,
               atol: float, what: str = ""):
    """Make numpy inputs from `seed`, call the JAX function and its port
    counterpart on them in `dtype` ("f64" | "f32"), compare, return both."""
    inputs = make_inputs(np.random.default_rng(seed))
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        ref = to_numpy(jax_fn(*(jnp.asarray(a, dtype=jdt) for a in inputs)))
    got = port_fn(*(torch.as_tensor(a, dtype=tdt) for a in inputs))
    assert_close(got, ref, rtol=rtol, atol=atol, what=what)
    return got, ref


# ---- whole solves on toy_biped (tests/test_torch_variants*.py, test_torch_ddp.py) ----

SOLVE_TOL = {"f64": 1e-6, "f32": 2e-3}   # x max(1, max|ref|), as tests/test_torch_sqp.py


def _setups():
    return {"stance": port_interface.stance_reference, "walk": port_interface.walking_reference}


def jax_solutions(make_solver, config_fields: dict, N: int, dtypes=("f64",)) -> dict:
    """{(setup, dtype): (xs, us, cost, g_norm, step_size, lam)} as numpy: the
    JAX solver `make_solver(ocp, flow, bp, SqpSolverConfig(N, dt, **fields))`,
    jitted once per dtype, on the toy_biped problem of
    `wb_humanoid_mpc_tpu_torch.interface.build_wb_problem` for each setup."""
    from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
    from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
    from wb_humanoid_mpc_tpu.refs.swing import SwingReference
    from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig
    from wb_humanoid_mpc_tpu.solver.transcription import Trajectory

    cfg, model, ocp = jax_wb("toy_biped")
    out = {}
    for dtype in dtypes:
        jdt = DTYPES[dtype][0]
        with jax_mode(dtype):
            solve = jax.jit(make_solver(ocp, model.flow_map, ocp.barrier_params(),
                                        SqpSolverConfig(n_nodes=N, dt=cfg.sqp.dt,
                                                        **config_fields)))
            for setup, reference in _setups().items():
                ref = reference(N)
                swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos,
                                       z_vel=ref.z_vel, z_acc=ref.z_acc, proximity=ref.proximity)
                x0 = jnp.asarray(cfg.initial_state, dtype=jdt)
                params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
                u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity, jnp.ones(2),
                                       model.layout.input_dim)
                traj = Trajectory(xs=jnp.tile(x0, (N + 1, 1)), us=jnp.tile(u0, (N, 1)))
                sol = solve(0.0, x0, traj, params, jnp.zeros((N, ocp.n_eq), jdt))
                out[(setup, dtype)] = to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm,
                                                sol.step_size, sol.lam))
    return out


def port_problem(setup: str, N: int, dtype: str):
    """The toy_biped problem of `jax_solutions` in the port, on the CPU."""
    return port_interface.build_wb_problem(ASSETS / "toy_biped", N, device="cpu",
                                           dtype=DTYPES[dtype][1], swing=_setups()[setup](N))


def assert_solution_close(sol, ref, dtype: str, what: str) -> None:
    """A port SqpSolution against `jax_solutions`' tuple: traj, cost, g_norm
    and multipliers at SOLVE_TOL[dtype] x max(1, max|ref|), the same step."""
    got = to_numpy((sol.traj.xs, sol.traj.us, sol.cost, sol.g_norm, sol.lam))
    for name, a, b in zip(("traj.xs", "traj.us", "cost", "g_norm", "lam"), got,
                          (*ref[:4], ref[5])):
        b = np.asarray(b, np.float64)
        limit = SOLVE_TOL[dtype] * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        assert err <= limit, f"{what} {name}: {err:.3e} > {limit:.3e}"
    assert np.isfinite(got[2])
    assert float(sol.step_size) == float(ref[4]), f"{what}: step {float(sol.step_size)} vs {ref[4]}"


def check_variant(jax_refs: dict, fields: dict, setup: str, dtype: str, N: int) -> None:
    """The port's `make_sqp_solver` with `fields` against `jax_refs[(setup, dtype)]`."""
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver

    pb = port_problem(setup, N, dtype)
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=N, dt=pb.cfg.sqp.dt, **fields), device="cpu")
    sol = solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)
    assert sol.iterations == fields.get("sqp_iterations", 1)
    assert_solution_close(sol, jax_refs[(setup, dtype)], dtype, f"{fields} {setup} {dtype}")


# ---- the closed loop (tests/test_torch_closed_loop_*.py) ----

LOOP_TOL = 1e-8          # x max(1, max|ref|), f64, per tick
LOOP_KW = dict(n_nodes=8, horizon=0.32)   # toy_biped, dt 0.04
TROT_AT = 0.1


def build_pair(formulation: str):
    """(JAX interface, port interface in f64 on the CPU) of `build_*_mpc` on
    toy_biped's committed files."""
    from wb_humanoid_mpc_tpu import interface as jax_interface

    files = port_interface.mpc_files(ASSETS / "toy_biped", formulation)
    jb = {"centroidal": jax_interface.build_centroidal_mpc,
          "wb": jax_interface.build_wb_mpc}[formulation]
    pb = {"centroidal": port_interface.build_centroidal_mpc,
          "wb": port_interface.build_wb_mpc}[formulation]
    return jb(*files, **LOOP_KW), pb(*files, **LOOP_KW, device="cpu", dtype=torch.float64)


def run_loop(mpc, run_dummy_sim, trot: bool, duration: float = 0.4):
    """The dummy-sim loop at 50/25 Hz from the initial state, zero command;
    with `trot`, `request_gait("trot")` at TROT_AT."""
    mpc.runtime.reset()
    fired = []

    def command_fn(t):
        if trot and t >= TROT_AT and not fired:
            mpc.motion_manager.request_gait("trot")
            fired.append(t)
        return np.zeros(4)

    return run_dummy_sim(mpc.runtime, mpc.initial_state, duration, 50.0, 25.0,
                         command_fn=command_fn, flow=mpc.model.flow_map)


def assert_loop_close(got, ref, what: str, tol: float = LOOP_TOL) -> None:
    """Two DummySimLogs tick by tick: states, inputs and solve stats at
    tol x max(1, max|ref|), contact flags and step sizes equal."""
    assert got.states.shape == ref.states.shape, what
    np.testing.assert_array_equal(got.contact_flags, ref.contact_flags, err_msg=what)
    pairs = [("states", got.states, ref.states), ("inputs", got.inputs, ref.inputs)]
    for name in ("cost", "g_norm"):
        pairs.append((name, np.array([getattr(s, name) for s in got.solve_stats]),
                      np.array([getattr(s, name) for s in ref.solve_stats])))
    for name, a, b in pairs:
        limit = tol * max(1.0, float(np.abs(b).max()))
        err = np.abs(a - b).reshape(len(a), -1).max(axis=1)
        assert err.max() <= limit, (f"{what} {name}: tick {int(err.argmax())} off by "
                                    f"{err.max():.3e} > {limit:.3e}")
    assert [s.step_size for s in got.solve_stats] == [float(s.step_size)
                                                      for s in ref.solve_stats], what


def forced_recovery(mpc, g_last: float):
    """Two solves at t = 0 and 0.04 with the previous solve's g_norm set to
    `g_last` before the second: 2 > warm_reset_g takes the soft branch
    (recovery solver, shifted warm start), 20 > 10 warm_reset_g the hard one
    (recovery solver from the WeightCompInitializer trajectory). Returns
    (stats, policy xs, policy us, warm resets) of the second solve."""
    rt = mpc.runtime
    rt.reset()
    x0 = np.asarray(mpc.initial_state, dtype=float)
    rt.advance(0.0, x0, np.zeros(4))
    rt._last_g = g_last
    stats = rt.advance(0.04, x0, np.zeros(4))
    return stats, np.asarray(rt.policy.xs), np.asarray(rt.policy.us), rt.n_warm_resets


LOOP_CASES = ["stance", "trot", "soft_recovery", "hard_recovery", "f32_tick"]


class LoopPair:
    """One formulation's JAX and port interfaces on toy_biped, with the JAX
    results of each case computed once, on first use."""

    def __init__(self, formulation: str):
        from wb_humanoid_mpc_tpu.sim.dummy import run_dummy_sim as jax_run

        self.formulation = formulation
        self.jax, self.port = build_pair(formulation)
        self._jax_run = jax_run
        self._ref = {}

    def ref(self, case: str):
        if case not in self._ref:
            if case in ("stance", "trot"):
                self._ref[case] = run_loop(self.jax, self._jax_run, case == "trot")
            elif case == "f32_tick":
                self._ref[case] = forced_recovery(self.jax, 0.0)
            else:
                self._ref[case] = forced_recovery(
                    self.jax, 2.0 if case == "soft_recovery" else 20.0)
        return self._ref[case]


def check_loop_case(pair: LoopPair, case: str) -> None:
    from wb_humanoid_mpc_tpu_torch.interface import build_centroidal_mpc, build_wb_mpc
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim

    ref = pair.ref(case)
    what = f"{pair.formulation} {case}"
    if case in ("stance", "trot"):
        got = run_loop(pair.port, run_dummy_sim, case == "trot")
        assert_loop_close(got, ref, what)
        assert all(s.iterations == 2 for s in got.solve_stats if not s.recovery)
        if case == "trot":
            # the last solve's horizon holds single-support nodes in both
            flags = [pair.port.runtime.policy.contact_flags, pair.jax.runtime.policy.contact_flags]
            np.testing.assert_array_equal(*flags)
            assert (flags[0].sum(axis=1) < 2).any(), "no single support after the trot"
        return
    if case == "f32_tick":
        # the port in float32 against JAX's float64 solve of the same tick
        build = build_centroidal_mpc if pair.formulation == "centroidal" else build_wb_mpc
        mpc = build(*port_interface.mpc_files(ASSETS / "toy_biped", pair.formulation),
                    **LOOP_KW, device="cpu", dtype=torch.float32)
        got = forced_recovery(mpc, 0.0)
        tol = SOLVE_TOL["f32"]
    else:
        got = forced_recovery(pair.port, 2.0 if case == "soft_recovery" else 20.0)
        tol = LOOP_TOL
        assert got[0].recovery and got[0].iterations == 12, what
        assert got[3] == ref[3] == (1 if case == "hard_recovery" else 0), what
    (gs, gxs, gus, _), (rs, rxs, rus, _) = got, ref
    for name, a, b in (("xs", gxs, rxs), ("us", gus, rus),
                       ("cost", gs.cost, float(rs.cost)), ("g_norm", gs.g_norm, float(rs.g_norm))):
        b = np.asarray(b, np.float64)
        limit = tol * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        assert err <= limit, f"{what} {name}: {err:.3e} > {limit:.3e}"
    assert gs.step_size == float(rs.step_size), what


# ---- the 2-D sharded solve (tests/test_torch_sharded_sqp*.py) ----

SHARDED_N, SHARDED_B, SHARDED_ITERS = 14, 4, 2   # walking, two swing phases; pads h = 2
SHARDED_TIMEOUT_S = 300.0
SHARDED_TOL = 1e-8          # x max(1, max|ref|): the port against JAX on one mesh shape
# JAX's own sharded-vs-vmapped tolerance (tests/test_sharded_sqp.py)
VS_BATCHED_TOL = {"xs": dict(rtol=1e-4, atol=1e-6), "us": dict(rtol=1e-4, atol=1e-5)}


def sharded_case(n_dp: int, n_h: int) -> dict:
    """Arguments of `dryrun.sharded_sqp_case` for the toy_biped walk, f64 on the CPU."""
    return dict(robot="toy_biped", n_nodes=SHARDED_N, batch=SHARDED_B, n_dp=n_dp, n_h=n_h,
                backend="gloo", device="cpu", dtype="float64", iterations=SHARDED_ITERS)


def _jax_walk():
    """(cfg, ocp, flow, x0s, warm start, params, multipliers) of JAX for the
    toy_biped walk of `dryrun.walking_problem`: B = SHARDED_B instances from
    x0 + SPREAD N(0, 1) (seed 0), every node of the warm start at x0."""
    from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
    from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
    from wb_humanoid_mpc_tpu.refs.swing import SwingReference
    from wb_humanoid_mpc_tpu.solver.transcription import Trajectory
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import SPREAD

    N, B = SHARDED_N, SHARDED_B
    cfg, model, ocp = jax_wb("toy_biped")
    ref = port_interface.walking_reference(N)
    swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos, z_vel=ref.z_vel,
                           z_acc=ref.z_acc, proximity=ref.proximity)
    x0 = jnp.asarray(cfg.initial_state, dtype=jnp.float64)
    params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
    u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity, jnp.ones(2),
                           model.layout.input_dim)
    noise = np.random.default_rng(0).standard_normal((B, x0.shape[0])) * SPREAD
    return (cfg, ocp, model.flow_map, x0 + jnp.asarray(noise),
            Trajectory(xs=jnp.tile(x0, (B, N + 1, 1)), us=jnp.tile(u0, (B, N, 1))),
            jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), params),
            jnp.zeros((B, N, ocp.n_eq)))


def _jax_fields(sol) -> dict:
    return dict(zip(("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size"),
                    to_numpy((sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm,
                              sol.defect_norm, sol.step_size))))


def jax_sharded(n_dp: int, n_h: int) -> dict:
    """JAX's `make_sharded_sqp_solver` on the same walk, on an n_dp x n_h mesh
    of virtual CPU devices, as numpy."""
    from jax.sharding import Mesh

    from wb_humanoid_mpc_tpu.solver.sharded_sqp import make_sharded_sqp_solver
    from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig

    cfg, ocp, flow, *inputs = _jax_walk()
    mesh = Mesh(np.array(jax.devices()[:n_dp * n_h]).reshape(n_dp, n_h), ("dp", "h"))
    solve = make_sharded_sqp_solver(ocp, flow, ocp.barrier_params(),
                                    SqpSolverConfig(n_nodes=SHARDED_N, dt=cfg.sqp.dt,
                                                    sqp_iterations=SHARDED_ITERS), mesh)
    return _jax_fields(solve(0.0, *inputs))


def jax_shard_batched(n_dp: int) -> dict:
    """JAX's `shard_batched_solver` on the same walk, the batch laid over the
    "dp" axis of a mesh of n_dp virtual CPU devices, as numpy."""
    from jax.sharding import Mesh

    from wb_humanoid_mpc_tpu.parallel.batched import shard_batched_solver
    from wb_humanoid_mpc_tpu.solver.sqp import SqpSolverConfig

    cfg, ocp, flow, *inputs = _jax_walk()
    mesh = Mesh(np.array(jax.devices()[:n_dp]), ("dp",))
    solve, shard = shard_batched_solver(ocp, flow, ocp.barrier_params(),
                                        SqpSolverConfig(n_nodes=SHARDED_N, dt=cfg.sqp.dt,
                                                        sqp_iterations=SHARDED_ITERS), mesh)
    return _jax_fields(solve(0.0, *shard(tuple(inputs))))


def port_batched_walk() -> dict:
    """The port's `make_batched_solver` on the same walk (f64, CPU), as numpy."""
    from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver
    from wb_humanoid_mpc_tpu_torch.parallel.dryrun import walking_problem
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig

    pb, *inputs = walking_problem("toy_biped", SHARDED_N, SHARDED_B, device="cpu",
                                  dtype=torch.float64)
    solve = make_batched_solver(pb.ocp, pb.model.flow_map, pb.bp,
                                SqpSolverConfig(n_nodes=SHARDED_N, dt=pb.cfg.sqp.dt,
                                                sqp_iterations=SHARDED_ITERS), device="cpu")
    sol = solve(0.0, *inputs)
    return dict(zip(("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size"),
                    to_numpy((sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm,
                              sol.defect_norm, sol.step_size))))


def assert_fields_close(got: dict, ref: dict, fields, tol: float, what: str) -> None:
    """Each field within tol x max(1, max|ref|); the same steps."""
    for name in fields:
        b = np.asarray(ref[name], np.float64)
        limit = tol * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(got[name], np.float64) - b).max())
        assert err <= limit, f"{what} {name}: {err:.3e} > {limit:.3e}"
    np.testing.assert_array_equal(got["step_size"], ref["step_size"], err_msg=what)


def check_sharded_runs(runs: list, n_dp: int, n_h: int, jax_ref: dict, batched: dict) -> None:
    """Every rank's `sharded_sqp_case` result on an n_dp x n_h mesh: the whole
    solution, the same on every rank; against JAX's sharded solve on the same
    mesh shape at SHARDED_TOL and against the port's batched solve at JAX's
    sharded-vs-vmapped tolerance, the same steps; `flow_batch` called 9 times
    an SQP iteration (3 for the RK4 tail, 3 for the 8-step sweep over steps x
    rows x local nodes, 3 for the final merit) and the collectives of the
    design (6 gathers and 5 reductions an iteration, 2 gathers at the end)."""
    N, B, it = SHARDED_N, SHARDED_B, SHARDED_ITERS
    K = -(-(N + 1) // n_h)
    rows = B // n_dp * K
    assert sorted(r["coords"] for r in runs) == [(i, j) for i in range(n_dp) for j in range(n_h)]
    first = runs[0]
    assert first["xs"].shape == (B, N + 1, first["xs"].shape[-1])
    assert first["us"].shape[:2] == (B, N)
    for r in runs[1:]:
        for k in ("xs", "us", "cost", "g_norm", "defect_norm", "step_size"):
            np.testing.assert_array_equal(r[k], first[k], err_msg=f"rank {r['coords']} {k}")
    for r in runs:
        assert r["flow_batch_calls"] == {rows: 6 * it, 8 * rows: 3 * it}, r["flow_batch_calls"]
        assert r["collectives"] == {"all_gather": 6 * it + 2, "all_reduce": 5 * it}
        assert r["report"]["axes"] == {"dp": n_dp, "h": n_h}
    what = f"sharded {n_dp}x{n_h}"
    assert_fields_close(first, jax_ref, ("xs", "us", "cost", "g_norm", "defect_norm"),
                        SHARDED_TOL, f"{what} vs JAX's sharded solve")
    for name, tol in VS_BATCHED_TOL.items():
        np.testing.assert_allclose(first[name], batched[name], **tol,
                                   err_msg=f"{what} vs make_batched_solver")
    np.testing.assert_array_equal(first["step_size"], batched["step_size"])
    assert np.isfinite(first["cost"]).all()
