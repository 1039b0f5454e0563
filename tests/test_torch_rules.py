"""PyTorch port, ground rules: the port imports neither JAX nor the JAX
package; its entry points default to the CUDA card and never carry on on the
CPU when there is none; a kernel wrapper asked for its kernel on CPU tensors
raises instead of running the plain version; config values the solver does
not know raise instead of being ignored; every public top-level name of the
JAX package has its counterpart at the same path in the port, but the
Pallas kernels that the CUDA kernels replace."""

from __future__ import annotations

import ast
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
from wb_humanoid_mpc_tpu_torch.parallel.multihost import MpcMesh, make_mpc_mesh, run_ranks
from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_throughput
from wb_humanoid_mpc_tpu_torch.sim import dummy as sim_dummy
from wb_humanoid_mpc_tpu_torch.solver.ddp import make_ddp_solver
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedShardedSolve, GraphedSqpSolve
from wb_humanoid_mpc_tpu_torch.solver.sharded_sqp import make_sharded_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    SqpSolverConfig,
    make_sqp_solver,
    make_staged_sqp_solver,
)
from wb_humanoid_mpc_tpu_torch.tools import bench, launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOY = interface.ASSETS / "toy_biped"
PHYSICS_AND_TOOLS = [f"wb_humanoid_mpc_tpu_torch.{m}" for m in (
    "sim.mujoco_sim", "sim.closed_loop", "sim.sim_thread", "viz.visualizer", "tools.launch",
    "tools.bench",
    "tools.commands", "tools.benchmarks", "tools.observation_logger", "tools.velocity_gui")]
OPTIONAL = ("mujoco", "matplotlib", "tkinter", "pygame")


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
    # the MuJoCo loop, its threads, the viz and the launch CLI
    assert set(PHYSICS_AND_TOOLS) <= set(mods)
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


def test_port_imports_without_the_optional_packages():
    """With mujoco, matplotlib, tkinter and pygame blocked, every module of
    the port imports; making a MuJoCo interface then raises an ImportError
    that names mujoco."""
    code = ("import importlib, json, sys\n"
            f"for name in {OPTIONAL!r}: sys.modules[name] = None\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface\n"
            "try:\n"
            "    MujocoSimInterface('robot.xml')\n"
            "    err = None\n"
            "except ImportError as e:\n"
            "    err = str(e)\n"
            f"loaded = sorted(n for n in {OPTIONAL!r} if sys.modules.get(n) is not None)\n"
            "print(json.dumps({'err': err, 'loaded': loaded}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and "mujoco" in got["err"]


def _toy_cli(command):
    urdf, task, ref, gait = interface.mpc_files(TOY, "wb")
    return [command, "--formulation", "wb", "--urdf", urdf, "--n-nodes", "3", "--duration",
            "0.1", "--batch", "2", "--rounds", "1"]


def _mujoco_loop(pb):
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import run_mujoco_closed_loop

    mpc = interface.build_wb_mpc(*interface.mpc_files(TOY, "wb"), n_nodes=3, device="cpu",
                                 dtype=torch.float64)
    return run_mujoco_closed_loop(mpc, WBMrtController(mpc.model), None, 0.1)


def _threaded_sim(pb):
    from wb_humanoid_mpc_tpu_torch.sim.sim_thread import run_threaded_robot_sim

    mpc = interface.build_centroidal_mpc(*interface.mpc_files(TOY, "centroidal"), n_nodes=3,
                                         device="cpu", dtype=torch.float64)
    return run_threaded_robot_sim(mpc, CentroidalMrtController(mpc.model), None, 0.1)


SIM_ENTRY_POINTS = {
    "launch.main dummy-sim": lambda pb: launch.main(_toy_cli("dummy-sim")),
    "launch.main mujoco-sim": lambda pb: launch.main(_toy_cli("mujoco-sim")),
    "launch.main bench-batched": lambda pb: launch.main(_toy_cli("bench-batched")),
    "launch._build": lambda pb: launch._build(launch.parse_args(_toy_cli("dummy-sim"))),
    "run_mujoco_closed_loop": _mujoco_loop,
    "run_threaded_robot_sim": _threaded_sim,
    "bench.main": lambda pb: bench.main(["--n-nodes", "3", "--timed", "1",
                                         "--latency-samples", "1"]),
}


@pytest.mark.parametrize("entry", list(SIM_ENTRY_POINTS))
def test_sim_and_cli_default_to_the_card(entry, toy_problem, no_card):
    """The CLI and the bench entry without `--device`, and both MuJoCo loops
    through their controllers' default device, raise on a machine without a
    card."""
    assert launch.parse_args(["dummy-sim"]).device == "cuda"
    assert bench.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SIM_ENTRY_POINTS[entry](toy_problem)


def test_mujoco_loop_refuses_a_controller_on_another_device():
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import run_mujoco_closed_loop

    mpc = interface.build_wb_mpc(*interface.mpc_files(TOY, "wb"), n_nodes=3, device="cpu",
                                 dtype=torch.float64)
    ctrl = WBMrtController(mpc.model, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="the controller runs on meta"):
        run_mujoco_closed_loop(mpc, ctrl, None, 0.1)


JAX_PACKAGE = REPO / "wb_humanoid_mpc_tpu"
PORT_PACKAGE = REPO / "wb_humanoid_mpc_tpu_torch"


def _public_names(path: Path, imported: bool) -> set[str]:
    """Public top-level names a module defines (functions, classes,
    assignments) and, with `imported`, the names it imports."""
    found = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            found.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            found |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            found |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in found if not n.startswith("_")}


def test_every_public_jax_name_has_a_counterpart():
    """Module by module, by the AST: each public top-level name of the JAX
    package is defined (or imported) at the same path in the port. The only
    exceptions are the Pallas kernels `ops/*.py::pallas_*`, which the CUDA
    kernels of `csrc/` replace."""
    modules = sorted(JAX_PACKAGE.rglob("*.py"))
    assert len(modules) > 40
    missing, pallas = [], []
    for path in modules:
        rel = path.relative_to(JAX_PACKAGE)
        names = _public_names(path, imported=False)
        port = PORT_PACKAGE / rel
        have = _public_names(port, imported=True) if port.exists() else set()
        for name in sorted(names - have):
            if rel.parts[0] == "ops" and name.startswith("pallas_"):
                pallas.append(f"{rel}::{name}")
            else:
                missing.append(f"{rel}::{name}")
    assert missing == []
    assert pallas == ["ops/fkvel.py::pallas_fkvel", "ops/riccati.py::pallas_riccati_rollout",
                      "ops/rollout.py::pallas_forward_rollout"]


# ---- the compiled solve (`solver/graphs.py`) ----

def _plant_step(pb, graphs):
    step = sim_dummy.PlantStep(pb.model.flow_map, 0.02, torch.device("cpu"), torch.float64,
                               graphs)
    step(0.0, pb.x0.numpy(), pb.traj.us[0].numpy())
    return step.graph


def _dummy_sim(pb, graphs):
    """The plant step run_dummy_sim makes (its runtime's first solve runs
    after it)."""
    made = []

    class Spy(sim_dummy.PlantStep):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    runtime = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64)
    orig, sim_dummy.PlantStep = sim_dummy.PlantStep, Spy
    try:
        with pytest.raises(AttributeError, match="advance"):
            sim_dummy.run_dummy_sim(runtime, pb.x0.numpy(), 0.1, 50.0, 25.0,
                                    flow=pb.model.flow_map, graphs=graphs)
    finally:
        sim_dummy.PlantStep = orig
    return made[0].graph


def _one_rank_mesh():
    """A 1 x 1 mesh on the CPU with no process group: enough to build a
    sharded solver, not to call it."""
    return MpcMesh(grid=np.zeros((1, 1), dtype=int), coords=(0, 0), groups={"dp": None, "h": None},
                   backend="gloo", device=torch.device("cpu"), ranks_per_host=1)


GRAPHED = {
    # name -> (make(problem, graphs), is it graphed)
    "make_sqp_solver": (lambda pb, graphs: make_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt),
        device="cpu", graphs=graphs), lambda made: isinstance(made, GraphedSqpSolve)),
    "make_staged_sqp_solver": (lambda pb, graphs: make_staged_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt),
        device="cpu", graphs=graphs), lambda made: isinstance(made, GraphedSqpSolve)),
    "WBMrtController": (lambda pb, graphs: WBMrtController(
        pb.model, device="cpu", dtype=torch.float64, graphs=graphs),
        lambda made: made.graph is not None),
    "CentroidalMrtController": (lambda pb, graphs: CentroidalMrtController(
        pb.model, device="cpu", dtype=torch.float64, graphs=graphs),
        lambda made: made.graph is not None),
    "PlantStep": (_plant_step, lambda made: made is not None),
    "run_dummy_sim": (_dummy_sim, lambda made: made is not None),
    "make_sharded_sqp_solver": (lambda pb, graphs: make_sharded_sqp_solver(
        pb.ocp, pb.model.flow_map, pb.bp, SqpSolverConfig(n_nodes=3, dt=pb.cfg.sqp.dt),
        _one_rank_mesh(), device="cpu", graphs=graphs),
        lambda made: isinstance(made, GraphedShardedSolve)),
}


@pytest.mark.parametrize("entry", list(GRAPHED))
def test_graphs_on_the_cpu_raise(entry, toy_problem):
    """graphs=True asks for CUDA graphs: on the CPU it raises instead of
    running eagerly; graphs=None (the default) and False run eagerly there.
    (The whole-body toy problem's model stands in for the centroidal
    controller's: only its construction is asked.)"""
    make, graphed = GRAPHED[entry]
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        make(toy_problem, True)
    assert not graphed(make(toy_problem, None)) and not graphed(make(toy_problem, False))


# name -> (entry point, the default of its `device`: None where it runs on
# its runtime's device, and of its `graphs`: absent where it takes another's)
GRAPHED_DEFAULTS = {
    "make_sqp_solver": (make_sqp_solver, "cuda", None),
    "make_staged_sqp_solver": (make_staged_sqp_solver, "cuda", None),
    "WBMrtController": (WBMrtController, "cuda", None),
    "CentroidalMrtController": (CentroidalMrtController, "cuda", None),
    "run_dummy_sim": (sim_dummy.run_dummy_sim, None, None),
    "make_batched_solver": (make_batched_solver, "cuda", "absent"),
    "make_sharded_sqp_solver": (make_sharded_sqp_solver, "cuda", None),
}


@pytest.mark.parametrize("entry", list(GRAPHED_DEFAULTS))
def test_graphed_entry_points_default_to_the_card_and_graphs(entry):
    """The graphed entry points default to the card and to graphs there; the
    dummy sim steps its plant on its runtime's device; the batched solve
    takes `make_sqp_solver`'s default (no keyword of its own)."""
    fn, device, graphs = GRAPHED_DEFAULTS[entry]
    params = inspect.signature(fn).parameters
    assert (params["device"].default if "device" in params else None) == device
    assert (params["graphs"].default if "graphs" in params else "absent") == graphs


def test_graphs_module_imports_no_jax():
    """`solver/graphs.py` alone, in a fresh interpreter: no JAX module and no
    module of the JAX package is loaded, no kernel is built."""
    assert "wb_humanoid_mpc_tpu_torch.solver.graphs" in _port_modules()
    code = ("import json, sys\n"
            "import wb_humanoid_mpc_tpu_torch.solver.graphs\n"
            "from wb_humanoid_mpc_tpu_torch.ops import _lib\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'wb_humanoid_mpc_tpu'))\n"
            "print(json.dumps({'bad': bad, 'built': sorted(_lib._state)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": [], "built": []}
