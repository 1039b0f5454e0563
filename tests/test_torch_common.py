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
