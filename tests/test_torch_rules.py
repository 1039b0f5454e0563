"""PyTorch port, ground rules: the port imports neither JAX nor the JAX
package; its entry points default to the CUDA card and never carry on on the
CPU when there is none; a kernel wrapper asked for its kernel on CPU tensors
raises instead of running the plain version; config values the solver does
not know raise instead of being ignored."""

from __future__ import annotations

import inspect
import json
import pkgutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import wb_humanoid_mpc_tpu_torch
from wb_humanoid_mpc_tpu_torch import convert, interface
from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline
from wb_humanoid_mpc_tpu_torch.mpc.controller import CentroidalMrtController, WBMrtController
from wb_humanoid_mpc_tpu_torch.mpc.runtime import MpcRuntime
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import NodeParams
from wb_humanoid_mpc_tpu_torch.ops import _lib, fkvel, riccati, rollout
from wb_humanoid_mpc_tpu_torch.parallel import dryrun
from wb_humanoid_mpc_tpu_torch.parallel.batched import make_batched_solver, shard_batched_solver
from wb_humanoid_mpc_tpu_torch.parallel.horizon import horizon_sharded_lq_solve
from wb_humanoid_mpc_tpu_torch.parallel.multihost import make_mpc_mesh, run_ranks
from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_throughput
from wb_humanoid_mpc_tpu_torch.solver.ddp import make_ddp_solver
from wb_humanoid_mpc_tpu_torch.solver.sharded_sqp import make_sharded_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    SqpSolverConfig,
    make_sqp_solver,
    make_staged_sqp_solver,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOY = interface.ASSETS / "toy_biped"


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(wb_humanoid_mpc_tpu_torch.__path__,
                                                        "wb_humanoid_mpc_tpu_torch."))


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: no `jax*` and
    no `wb_humanoid_mpc_tpu.*` module may be loaded, and neither a kernel
    nor the native MRT core built."""
    mods = _port_modules()
    assert "wb_humanoid_mpc_tpu_torch.solver.sqp" in mods and len(mods) > 20
    # the closed loop: reference pipeline, centroidal formulation, runtime, sim
    assert {"wb_humanoid_mpc_tpu_torch.refs.gait", "wb_humanoid_mpc_tpu_torch.refs.swing",
            "wb_humanoid_mpc_tpu_torch.refs.targets", "wb_humanoid_mpc_tpu_torch.refs.manager",
            "wb_humanoid_mpc_tpu_torch.models.centroidal_model",
            "wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp", "wb_humanoid_mpc_tpu_torch.mpc.gains",
            "wb_humanoid_mpc_tpu_torch.mpc.runtime", "wb_humanoid_mpc_tpu_torch.sim.dummy",
            } <= set(mods)
    # the host runtime and the batched solve
    assert {"wb_humanoid_mpc_tpu_torch.native", "wb_humanoid_mpc_tpu_torch.mpc.controller",
            "wb_humanoid_mpc_tpu_torch.mpc.async_runtime",
            "wb_humanoid_mpc_tpu_torch.parallel.batched",
            "wb_humanoid_mpc_tpu_torch.parallel.scaling"} <= set(mods)
    # the multi-device layer
    assert {"wb_humanoid_mpc_tpu_torch.parallel.collectives",
            "wb_humanoid_mpc_tpu_torch.parallel.multihost",
            "wb_humanoid_mpc_tpu_torch.parallel.horizon",
            "wb_humanoid_mpc_tpu_torch.parallel.dryrun",
            "wb_humanoid_mpc_tpu_torch.solver.sharded_sqp"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from wb_humanoid_mpc_tpu_torch.ops import _lib\n"
            "from wb_humanoid_mpc_tpu_torch import native\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'wb_humanoid_mpc_tpu'))\n"
            "print(json.dumps({'bad': bad,\n"
            "                  'built': sorted(_lib._state) + sorted(native._state)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "built": []}


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a CUDA card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def toy_problem():
    return interface.build_wb_problem(TOY, 3, device="cpu", dtype=torch.float64)


ENTRY_POINTS = {
    "build_wb_problem": lambda pb: interface.build_wb_problem(TOY, 3),
    "make_sqp_solver": lambda pb: make_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt)),
    "make_staged_sqp_solver": lambda pb: make_staged_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt)),
    "make_ddp_solver": lambda pb: make_ddp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt)),
    "node_params_from_numpy": lambda pb: convert.node_params_from_numpy(
        {f: getattr(pb.params, f).numpy() for f in pb.params._fields}),
    "trajectory_from_numpy": lambda pb: convert.trajectory_from_numpy(
        pb.traj.xs.numpy(), pb.traj.us.numpy()),
    "centroidal_node_params_from_numpy": lambda pb: convert.centroidal_node_params_from_numpy(
        {f: np.zeros((2, 3)) for f in NodeParams._fields}),
    "build_wb_mpc": lambda pb: interface.build_wb_mpc(*interface.mpc_files(TOY, "wb"), n_nodes=3),
    "build_centroidal_mpc": lambda pb: interface.build_centroidal_mpc(
        *interface.mpc_files(TOY, "centroidal"), n_nodes=3),
    "MpcRuntime": lambda pb: MpcRuntime(None, None, None, 3, 0.1, 14, np.zeros(24)),
    "CentroidalMrtController": lambda pb: CentroidalMrtController(pb.model),
    "WBMrtController": lambda pb: WBMrtController(pb.model),
    "MrtPipeline": lambda pb: MrtPipeline(
        MpcRuntime(None, None, None, 3, 0.1, 14, np.zeros(24), device="cpu"), 4),
    "make_batched_solver": lambda pb: make_batched_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt)),
    "batched_throughput": lambda pb: batched_throughput(2, n_nodes=3),
    "make_sharded_sqp_solver": lambda pb: make_sharded_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt), None),
    "horizon_sharded_lq_solve": lambda pb: horizon_sharded_lq_solve(*_cpu_lq(), None),
    "shard_batched_solver": lambda pb: shard_batched_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt), None),
    "make_mpc_mesh": lambda pb: make_mpc_mesh(1, 1, backend="gloo"),
    "run_ranks": lambda pb: run_ranks(dryrun.run_cases, 1, "gloo"),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, toy_problem, no_card):
    fn = {"build_wb_problem": interface.build_wb_problem, "make_sqp_solver": make_sqp_solver,
          "make_staged_sqp_solver": make_staged_sqp_solver, "make_ddp_solver": make_ddp_solver,
          "node_params_from_numpy": convert.node_params_from_numpy,
          "trajectory_from_numpy": convert.trajectory_from_numpy,
          "centroidal_node_params_from_numpy": convert.centroidal_node_params_from_numpy,
          "build_wb_mpc": interface.build_wb_mpc,
          "build_centroidal_mpc": interface.build_centroidal_mpc,
          "MpcRuntime": MpcRuntime, "CentroidalMrtController": CentroidalMrtController,
          "WBMrtController": WBMrtController, "MrtPipeline": MrtPipeline,
          "make_batched_solver": make_batched_solver,
          "batched_throughput": batched_throughput,
          "make_sharded_sqp_solver": make_sharded_sqp_solver,
          "horizon_sharded_lq_solve": horizon_sharded_lq_solve,
          "shard_batched_solver": shard_batched_solver, "make_mpc_mesh": make_mpc_mesh,
          "run_ranks": run_ranks}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](toy_problem)


def test_solver_refuses_tensors_of_another_device(toy_problem):
    pb = toy_problem
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt), device="cpu")
    meta = pb.x0.to("meta")
    with pytest.raises(ValueError, match="solver built for cpu"):
        solve(0.0, meta, pb.traj, pb.params, pb.lam)


def _cpu_lq():
    data = riccati.random_lq_data(np.random.default_rng(0), 3, 6, 2, dtype=np.float64)
    t = {k: torch.as_tensor(v) for k, v in data.items()}
    return types.SimpleNamespace(**{k: v for k, v in t.items() if k != "dx0"}), t["dx0"]


def _call_riccati_cuda(pb):
    lq, dx0 = _cpu_lq()
    return riccati.riccati_rollout(lq, dx0, backend="cuda")


def _call_riccati_wrapper(pb):
    lq, dx0 = _cpu_lq()
    return riccati.riccati_rollout_cuda(lq.A, lq.B, lq.d, lq.Qxx, lq.Quu, lq.Qux, lq.qx,
                                        lq.qu, lq.QN, lq.qN, dx0)


def _cpu_stages():
    data = rollout.random_stage_data(np.random.default_rng(0), 3, 6, 2, dtype=np.float64)
    return [torch.as_tensor(data[k]) for k in ("A", "B", "d", "K", "k", "dx0")]


def _call_rollout_cuda(pb):
    A, B, d, K, k, dx0 = _cpu_stages()
    return rollout.forward_rollout(types.SimpleNamespace(A=A, B=B, d=d),
                                   types.SimpleNamespace(K=K, k=k), dx0, backend="cuda")


def _call_rollout_wrapper(pb):
    return rollout.forward_rollout_cuda(*_cpu_stages())


def _call_fkvel_cuda(pb):
    q = torch.zeros(4, pb.model.robot.nq, dtype=torch.float64)
    return fkvel.fkvel_batch(pb.model.robot, q, q, backend="cuda")


def _call_flow_map_batch_cuda(pb):
    return pb.model.flow_map_batch(torch.zeros(3, dtype=torch.float64), pb.traj.xs[:3],
                                   pb.traj.us, backend="cuda")


def _call_solver_cuda(pb):
    solve = make_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp,
                            SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt,
                                            rollout_backend="cuda"), device="cpu")
    return solve(0.0, pb.x0, pb.traj, pb.params, pb.lam)


@pytest.mark.parametrize("call", [_call_riccati_cuda, _call_riccati_wrapper, _call_rollout_cuda,
                                  _call_rollout_wrapper, _call_fkvel_cuda,
                                  _call_flow_map_batch_cuda, _call_solver_cuda],
                         ids=lambda f: f.__name__[len("_call_"):])
def test_kernel_backend_refuses_cpu_tensors(call, toy_problem):
    """backend='cuda' on CPU tensors raises before anything is built or
    counted: a kernel wrapper never falls back to its plain version."""
    before = (riccati.LAUNCHES, fkvel.LAUNCHES, rollout.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        call(toy_problem)
    assert (riccati.LAUNCHES, fkvel.LAUNCHES, rollout.LAUNCHES) == before
    assert "lib" not in _lib._state


@pytest.mark.parametrize("backend_of", ["riccati", "fkvel", "rollout"])
def test_unknown_backend_raises(backend_of, toy_problem):
    lq, dx0 = _cpu_lq()
    with pytest.raises(ValueError, match="unknown"):
        if backend_of == "riccati":
            riccati.riccati_rollout(lq, dx0, backend="xla")
        elif backend_of == "rollout":
            rollout.forward_rollout(lq, types.SimpleNamespace(K=lq.Qux, k=lq.qu), dx0,
                                    backend="xla")
        else:
            q = torch.zeros(2, toy_problem.model.robot.nq, dtype=torch.float64)
            fkvel.fkvel_batch(toy_problem.model.robot, q, q, backend="xla")


@pytest.mark.parametrize("field,value", [("equality_handling", "penalty"),
                                         ("line_search", "armijo"), ("sensitivity", "euler")])
def test_unknown_config_value_raises(field, value, toy_problem):
    pb = toy_problem
    cfg = SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt, **{field: value})
    for make in (make_sqp_solver, make_staged_sqp_solver):
        with pytest.raises(ValueError, match=field):
            make(pb.ocp, pb.model.flow_map, pb.bp, cfg, device="cpu")
