"""Cases of the compiled solve's CPU tests (tests/test_torch_graphs*.py).

Both packages solve a time-dependent variant of the whole-body OCP on
toy_biped: every stage and terminal residual is shifted by
TIME_GAIN sin(t), so that a solve at another time than its call's t0 (a
time baked into a CUDA graph) changes the answer. The port runs each case's
calls through the eager `make_sqp_solver` and through the graphed solve's
static-buffer runner with capture off (`GraphedSqpSolve(..., capture=False)`);
JAX's jitted one-iteration solve replays the same calls, k iterations as k
calls (what its `lax.scan` over iterations computes, the multipliers
carried on the AL path).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import torch

from tests._graphs_common import TIME_GAIN, TimedPortOcp
from tests.test_torch_common import DTYPES, jax_wb, port_problem, to_numpy
from wb_humanoid_mpc_tpu.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WholeBodyOcp as JaxWholeBodyOcp
from wb_humanoid_mpc_tpu.ocp.wb_ocp import make_wb_node_params
from wb_humanoid_mpc_tpu.refs.swing import SwingReference
from wb_humanoid_mpc_tpu.solver.transcription import Trajectory as JaxTrajectory
from wb_humanoid_mpc_tpu_torch.interface import stance_reference
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpIteration, SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

SPREAD = np.array([0.005, 0.005, 0.05])   # x0 noise a row: the third row needs the lower ladder
FIELDS = ("xs", "us", "lam", "cost", "g_norm", "defect_norm", "step_size")


class TimedJaxOcp(JaxWholeBodyOcp):
    def fused_node(self, t, x, u, p):
        terms, xdot = super().fused_node(t, x, u, p)
        return terms._replace(r=terms.r + TIME_GAIN * jnp.sin(t)), xdot

    def terminal_residual(self, t, x, p):
        return super().terminal_residual(t, x, p) + TIME_GAIN * jnp.sin(t)


class Call(NamedTuple):
    t0: float
    noise_row: int | None = None   # x0 + that row of the noise; None: the nominal x0
    params: int = 0                # 1: x_ref shifted by PARAMS_SHIFT
    warm: bool = False             # start from the previous call's solution


# name -> (SQP iterations, batch of 3, calls)
CASES = {
    "iterations_2": (2, False, [Call(0.0)]),
    "iterations_12": (12, False, [Call(0.0)]),
    "lower_ladder": (1, False, [Call(0.0, noise_row=2)]),
    "batch_3": (1, True, [Call(0.0)]),
    "t0_changes": (1, False, [Call(0.0), Call(0.35), Call(0.7)]),
    "params_change": (1, False, [Call(0.1), Call(0.1, params=1)]),
    "warm_start": (1, False, [Call(0.0), Call(0.05, warm=True), Call(0.1, warm=True)]),
}


def _noise(nx: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal((3, nx)) * SPREAD[:, None]


def _params_shift(shape) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(shape) * 0.01


def timed_jax_ocp(robot: str):
    cfg, model, _ = jax_wb(robot)
    return cfg, model, TimedJaxOcp(model=model, cfg=cfg)


def jax_problem(cfg, model, ocp, n_nodes: int, jdt):
    """(x0, warm start, params, multipliers) of the stance problem in JAX."""
    N = n_nodes
    ref = stance_reference(N)
    swing = SwingReference(contact_flags=ref.contact_flags, z_pos=ref.z_pos, z_vel=ref.z_vel,
                           z_acc=ref.z_acc, proximity=ref.proximity)
    x0 = jnp.asarray(cfg.initial_state, dtype=jdt)
    params = make_wb_node_params(ocp, swing, jnp.tile(x0, (N + 1, 1)))
    u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity, jnp.ones(2),
                           model.layout.input_dim)
    traj = JaxTrajectory(xs=jnp.tile(x0, (N + 1, 1)), us=jnp.tile(u0, (N, 1)).astype(jdt))
    return x0, traj, params, jnp.zeros((N, ocp.n_eq), jdt)


def solvers(n_nodes: int, dtype: str, iterations: int, fields: dict):
    """(problem, eager solve, runner) of the time-dependent toy_biped OCP in the port."""
    pb = port_problem("stance", n_nodes, dtype)
    ocp = TimedPortOcp(model=pb.model, cfg=pb.cfg)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=iterations, **fields)
    eager = make_sqp_solver(ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
    split = GraphedSqpSolve(SqpIteration(ocp, pb.model.flow_map, pb.bp, cfg),
                            torch.device("cpu"), capture=False)
    return pb, eager, split


@functools.lru_cache(maxsize=None)
def port_runs(case: str, n_nodes: int, dtype: str, fields: tuple = ()):
    """(eager solutions, runner solutions, calls) of a case, one a call."""
    iterations, batched, calls = CASES[case]
    pb, eager, split = solvers(n_nodes, dtype, iterations, dict(fields))
    tdt = pb.x0.dtype
    noise = torch.as_tensor(_noise(pb.x0.shape[0]), dtype=tdt)
    shift = torch.as_tensor(_params_shift(tuple(pb.params.x_ref.shape)), dtype=tdt)

    def rep(a):
        return a.expand(3, *a.shape).contiguous() if batched else a

    out = {}
    for name, solve in (("eager", eager), ("split", split)):
        sols, prev = [], None
        for c in calls:
            x0 = pb.x0 + noise if batched else (
                pb.x0 if c.noise_row is None else pb.x0 + noise[c.noise_row])
            params = pb.params._replace(x_ref=pb.params.x_ref + shift) if c.params else pb.params
            params = type(params)(*(rep(a) for a in params))
            traj = (prev.traj if c.warm else
                    Trajectory(xs=rep(pb.traj.xs), us=rep(pb.traj.us)))
            lam = prev.lam if c.warm else rep(pb.lam)
            prev = solve(c.t0, x0, traj, params, lam)
            sols.append(prev)
        out[name] = sols
    return out["eager"], out["split"], calls


def _fields(sol):
    return (sol.traj.xs, sol.traj.us, sol.lam, sol.cost, sol.g_norm, sol.defect_norm,
            sol.step_size)


def assert_bitwise(got, ref, what: str) -> None:
    for k, (a, b) in enumerate(zip(got, ref)):
        for name, x, y in zip(FIELDS, _fields(a), _fields(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), (
                f"{what} call {k} {name}: runner and eager differ by "
                f"{float((x - y).abs().max()):.3e}")
        assert a.iterations == b.iterations


def assert_close_to_jax(got, calls, jax_setup, tol: float, what: str, iterations: int,
                        batched: bool, jax_context=contextlib.nullcontext) -> None:
    """Each call's runner solution against JAX's one-iteration solve applied
    `iterations` times from the same start, per instance of a batch:
    xs, us, multipliers, cost and g_norm within tol max(1, max|ref|), the
    same step."""
    solve, (x0, traj0, params0, lam0) = jax_setup
    noise = _noise(x0.shape[0])
    shift = _params_shift(tuple(params0.x_ref.shape))
    instances = range(3) if batched else [None]
    prev = {i: None for i in instances}
    for k, c in enumerate(calls):
        sol = to_numpy(_fields(got[k]))
        for i in instances:
            with jax_context():
                row = i if batched else c.noise_row
                x = x0 if row is None else x0 + jnp.asarray(noise[row], x0.dtype)
                params = (params0._replace(x_ref=params0.x_ref + jnp.asarray(shift, x0.dtype))
                          if c.params else params0)
                traj, lam = (prev[i] if c.warm else (traj0, lam0))
                for _ in range(iterations):
                    s = solve(c.t0, x, traj, params, lam)
                    traj, lam = s.traj, s.lam
                prev[i] = (traj, lam)
                ref = to_numpy((s.traj.xs, s.traj.us, s.lam, s.cost, s.g_norm, s.step_size))
            mine = [a if i is None else a[i] for a in sol]
            for name, a, b in zip(("xs", "us", "lam", "cost", "g_norm"),
                                  (*mine[:3], mine[3], mine[4]), ref[:5]):
                b = np.asarray(b, np.float64)
                limit = tol * max(1.0, float(np.abs(b).max()))
                err = float(np.abs(np.asarray(a, np.float64) - b).max())
                assert err <= limit, (f"{what} call {k} instance {i} {name}: max|port - JAX| "
                                      f"{err:.3e} > {limit:.3e}")
            assert float(mine[6]) == float(ref[5]), (
                f"{what} call {k} instance {i}: step {float(mine[6])}, JAX {float(ref[5])}")


def jax_dtype(dtype: str):
    return DTYPES[dtype][0]
