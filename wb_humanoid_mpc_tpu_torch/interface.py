"""Top-level assembly: config files -> ready-to-run problem or MPC runtime.

PyTorch counterpart of `wb_humanoid_mpc_tpu/interface.py` (the reference's
`CentroidalMpcInterface.cpp:151-237`, `WBMpcInterface.cpp:131-199`):
`build_centroidal_mpc` and `build_wb_mpc` load the task / reference / gait
info files, build the robot model and the formulation's OCP, the SQP solver
and its recovery twin, and wire the host-side reference pipeline into an
`MpcRuntime`; `sim/dummy.py::run_dummy_sim` closes the loop.

An asset directory holds `<name>.urdf`, a whole-body `task.info`, a
centroidal `task_centroidal.info` and a `reference_<formulation>.info` each;
`assets/gait.info` holds the gait templates of both robots (the port ships
`assets/humanoid23/`, the G1-width model, and `assets/toy_biped/`).
`build_wb_problem` builds the warm-start problem of `bench.py` from the
whole-body files, the way the JAX package's `_wb_setup` does
(`__graft_entry__.py`): all nodes at the initial state, gravity-compensating
inputs, zero multipliers.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.core.config import (
    TaskConfig,
    load_gait_library,
    load_reference_config,
    load_task_config,
)
from wb_humanoid_mpc_tpu_torch.models.centroidal_model import CentroidalModel
from wb_humanoid_mpc_tpu_torch.models.layout import CentroidalLayout, WBLayout
from wb_humanoid_mpc_tpu_torch.models.robot.factory import build_robot_model, mpc_joint_names
from wb_humanoid_mpc_tpu_torch.models.wb_model import WholeBodyModel
from wb_humanoid_mpc_tpu_torch.mpc.gains import GainsService
from wb_humanoid_mpc_tpu_torch.mpc.runtime import MpcRuntime
from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import CentroidalOcp
from wb_humanoid_mpc_tpu_torch.ocp.params import (
    centroidal_node_params,
    pack_centroidal_inputs,
    unpack_centroidal_inputs,
    weight_comp_input,
)
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams, WholeBodyOcp, make_wb_node_params
from wb_humanoid_mpc_tpu_torch.refs.manager import MotionManager, SolveReferences
from wb_humanoid_mpc_tpu_torch.refs.swing import SwingReference
from wb_humanoid_mpc_tpu_torch.refs.targets import CentroidalTargetCalculator, WBTargetCalculator
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedSqpSolve
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, make_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

ASSETS = Path(__file__).resolve().parent / "assets"


def asset_files(asset_dir) -> tuple[str, str]:
    """(urdf path, task.info path) of an asset directory."""
    d = Path(asset_dir)
    return str(d / f"{d.name}.urdf"), str(d / "task.info")


def mpc_files(asset_dir, formulation: str) -> tuple[str, str, str, str]:
    """(urdf, task, reference, gait) paths of an asset directory for
    `formulation` ("centroidal" | "wb"): the positional arguments of
    `build_centroidal_mpc` / `build_wb_mpc`."""
    if formulation not in ("centroidal", "wb"):
        raise ValueError(f"unknown formulation {formulation!r}")
    d = Path(asset_dir)
    urdf, task = asset_files(d)
    if formulation == "centroidal":
        task = str(d / "task_centroidal.info")
    return urdf, task, str(d / f"reference_{formulation}.info"), str(d.parent / "gait.info")


def load_wb_model(asset_dir) -> tuple[TaskConfig, WholeBodyModel]:
    """Task config + whole-body model (joint set = URDF joints minus the
    task's fixed joints, contact frames injected)."""
    urdf, task = asset_files(asset_dir)
    probe = load_task_config(task, "wb", 1, 1)
    joints = mpc_joint_names(urdf, probe.model_settings.fixed_joint_names)
    layout = WBLayout(n_joints=len(joints))
    cfg = load_task_config(task, "wb", layout.state_dim, layout.input_dim)
    robot = build_robot_model(urdf, cfg)
    return cfg, WholeBodyModel(robot=robot, layout=layout,
                               contact_frames=tuple(cfg.model_settings.contact_names))


def stance_reference(n_nodes: int) -> SwingReference:
    """Both feet in contact at every node (the `bench.py` setup)."""
    n1 = n_nodes + 1
    return SwingReference(contact_flags=np.ones((n1, 2)), z_pos=np.zeros((n1, 2)),
                          z_vel=np.zeros((n1, 2)), z_acc=np.zeros((n1, 2)),
                          proximity=np.ones((n1, 2)))


def walking_reference(n_nodes: int) -> SwingReference:
    """The walking schedule of `__graft_entry__.dryrun_multichip` (double
    support / left swing / double support / right swing, 7 nodes a phase at
    N = 28), with the phase length scaled to N."""
    n1 = n_nodes + 1
    block = max(2, round(7 * n_nodes / 28))
    k = np.arange(n1)
    flags = np.ones((n1, 2))
    phase = (k // block) % 4
    flags[phase == 1, 0] = 0.0
    flags[phase == 3, 1] = 0.0
    zs = 0.04 * np.sin(np.pi * ((k % block) / block))[:, None] * (flags < 0.5)
    return SwingReference(contact_flags=flags, z_pos=zs, z_vel=np.zeros((n1, 2)),
                          z_acc=np.zeros((n1, 2)), proximity=np.where(flags > 0.5, 1.0, 0.3))


class WBProblem(NamedTuple):
    cfg: TaskConfig
    model: WholeBodyModel
    ocp: WholeBodyOcp
    bp: BarrierParams
    x0: torch.Tensor        # [nx]
    traj: Trajectory        # warm start: xs [N+1, nx], us [N, nu]
    params: WBNodeParams    # [N+1, ...]
    lam: torch.Tensor       # [N, n_eq]


def build_wb_problem(asset_dir, n_nodes: int, *, device="cuda", dtype=torch.float32,
                     swing: SwingReference | None = None) -> WBProblem:
    """The whole-body SQP problem of `bench.py` for the robot in `asset_dir`:
    N = n_nodes intervals, stance unless another `swing` reference is given."""
    dev = resolve_device(device)
    cfg, model = load_wb_model(asset_dir)
    ocp = WholeBodyOcp(model=model, cfg=cfg)
    N = n_nodes
    x0 = torch.as_tensor(cfg.initial_state, dtype=dtype, device=dev)
    xs = x0.expand(N + 1, -1).clone()
    params = make_wb_node_params(ocp, swing or stance_reference(N), xs)
    u0 = weight_comp_input(model.robot.total_mass, model.robot.gravity,
                           torch.ones(2, dtype=dtype, device=dev), model.layout.input_dim)
    traj = Trajectory(xs=xs, us=u0.expand(N, -1).clone())
    lam = torch.zeros(N, ocp.n_eq, dtype=dtype, device=dev)
    return WBProblem(cfg=cfg, model=model, ocp=ocp, bp=ocp.barrier_params(dev, dtype),
                     x0=x0, traj=traj, params=params, lam=lam)


# ---- the closed-loop MPC interfaces ----

@dataclasses.dataclass
class CentroidalMpcInterface:
    cfg: TaskConfig
    model: CentroidalModel
    ocp: CentroidalOcp
    runtime: MpcRuntime
    motion_manager: MotionManager
    n_nodes: int
    dt: float
    gains: GainsService = None  # live re-tuning (reference GainsReceiver)

    @property
    def initial_state(self) -> np.ndarray:
        return np.asarray(self.cfg.initial_state)


@dataclasses.dataclass
class WBMpcInterface:
    cfg: TaskConfig
    model: WholeBodyModel
    ocp: WholeBodyOcp
    runtime: MpcRuntime
    motion_manager: MotionManager
    n_nodes: int
    dt: float
    gains: GainsService = None  # live re-tuning (reference GainsReceiver)

    @property
    def initial_state(self) -> np.ndarray:
        return np.asarray(self.cfg.initial_state)


def _arm_indices(cfg: TaskConfig, joint_names: list[str]) -> dict[str, int]:
    out = {}
    for role, jname in cfg.model_settings.arm_joint_names.items():
        if jname in joint_names:
            out[role] = joint_names.index(jname)
    return out


def _grid(cfg: TaskConfig, n_nodes, horizon, dt_override) -> tuple[int, float, float]:
    """(n_nodes, dt, horizon) as the JAX builders resolve them."""
    horizon = horizon if horizon is not None else cfg.mpc.time_horizon
    if dt_override is not None:
        dt = dt_override
    elif n_nodes is not None:
        # both n_nodes and horizon pinned -> dt follows
        dt = horizon / n_nodes
    else:
        dt = cfg.sqp.dt
    n_nodes = n_nodes if n_nodes is not None else int(round(horizon / dt))
    return n_nodes, dt, n_nodes * dt


def _assemble(cfg, model, ocp, joints, calc, joint_start, n_nodes, dt, horizon, ref_cfg,
              gait_file, sqp_iterations, solver_overrides, make_params, base_vel_extractor,
              dev, dtype):
    """MotionManager + solver + recovery solver + MpcRuntime + GainsService,
    shared by both builders."""
    mm = MotionManager(
        ref_cfg=ref_cfg,
        swing_cfg=cfg.swing,
        gait_map=load_gait_library(gait_file),
        target_calculator=calc,
        horizon=horizon,
        n_nodes=n_nodes,
        joint_start_index=joint_start,
        arm_indices=_arm_indices(cfg, joints),
        phase_transition_stance_time=cfg.model_settings.phase_transition_stance_time,
    )
    solver_cfg = SqpSolverConfig(
        n_nodes=n_nodes, dt=dt,
        sqp_iterations=sqp_iterations if sqp_iterations is not None
        else max(cfg.sqp.sqp_iteration, 2),
        **dict(solver_overrides or {}),
    )
    # divergence recovery: the same OCP at a 12-iteration budget
    recovery_cfg = dataclasses.replace(solver_cfg, sqp_iterations=12)

    def solvers():
        # on the card the solve runs as CUDA graphs, captured at its first
        # call; the recovery solve replays the same graphs 12 times
        bp = ocp.barrier_params(dev, dtype)
        solve = make_sqp_solver(ocp, model.flow_map, bp, solver_cfg, device=dev)
        if isinstance(solve, GraphedSqpSolve):
            return solve, solve.with_iterations(recovery_cfg.sqp_iterations)
        return solve, make_sqp_solver(ocp, model.flow_map, bp, recovery_cfg, device=dev)

    robot = model.robot
    u_default = weight_comp_input(robot.total_mass, robot.gravity,
                                  torch.ones(2, dtype=torch.float64),
                                  model.layout.input_dim).numpy()
    solve, recovery = solvers()
    runtime = MpcRuntime(
        solve_fn=solve, motion_manager=mm, make_node_params=make_params, n_nodes=n_nodes,
        dt=dt, n_eq=ocp.n_eq, default_input=u_default, base_vel_extractor=base_vel_extractor,
        recovery_solve_fn=recovery, device=dev, dtype=dtype)

    def _rebuild():
        # live gain re-tuning (reference `GainsReceiver.cpp:44`): the OCP's
        # weight tensors are rebuilt from the mutated cfg, and both solvers
        # with them; the old solvers' graphs (the recovery solve shares
        # them) read the old tensors, so they are dropped, and the new
        # solvers capture anew
        if isinstance(runtime.solve_fn, GraphedSqpSolve):
            runtime.solve_fn.release()
        ocp._cache.clear()
        runtime.solve_fn, runtime.recovery_solve_fn = solvers()

    return mm, runtime, GainsService(cfg, _rebuild)


def build_centroidal_mpc(
    urdf_path: str,
    task_file: str,
    reference_file: str,
    gait_file: str,
    n_nodes: int | None = None,
    horizon: float | None = None,
    sqp_iterations: int | None = None,
    solver_overrides: dict | None = None,
    dt_override: float | None = None,
    *,
    device="cuda",
    dtype=torch.float32,
) -> CentroidalMpcInterface:
    """Centroidal formulation assembly (reference
    `CentroidalMpcInterface.cpp:151-237`), on `device` in `dtype`."""
    dev = resolve_device(device)
    probe_cfg = load_task_config(task_file, "centroidal", 1, 1)
    joints = mpc_joint_names(urdf_path, probe_cfg.model_settings.fixed_joint_names)
    layout = CentroidalLayout(n_joints=len(joints))
    cfg = load_task_config(task_file, "centroidal", layout.state_dim, layout.input_dim)

    robot = build_robot_model(urdf_path, cfg)
    ref_cfg = load_reference_config(reference_file, layout.n_joints)
    model = CentroidalModel(
        robot=robot, layout=layout,
        contact_frames=tuple(cfg.model_settings.contact_names),
        srbm=(cfg.centroidal_model_type == 1),
        nominal_joint_angles=tuple(ref_cfg.default_joint_state.tolist()),
    )
    ocp = CentroidalOcp(model=model, cfg=cfg)
    n_nodes, dt, horizon = _grid(cfg, n_nodes, horizon, dt_override)
    calc = CentroidalTargetCalculator(ref_cfg=ref_cfg, mpc_horizon=horizon)

    # the node params' device work (its kinematics pass is ~330 launches
    # eagerly) as one CUDA graph on the card, captured at the first call;
    # eagerly on the same buffers on the CPU
    nx = layout.state_dim
    params_graph = GraphedFunction(
        lambda packed: centroidal_node_params(ocp, *unpack_centroidal_inputs(packed, nx)),
        dev, "params (the centroidal node params)", capture=dev.type == "cuda",
        upload="params_upload")

    def make_params(refs: SolveReferences):
        """The node params of `refs`: one upload, one replay. They are the
        graph's static tensors, which the next call overwrites, so the
        solve reads them within its tick (a graphed solve copies them in
        its `load`; the eager twin reads them before the next upload)."""
        packed = torch.as_tensor(pack_centroidal_inputs(refs.swing, refs.x_ref), dtype=dtype)
        return params_graph.run(packed)

    mm, runtime, gains = _assemble(
        cfg, model, ocp, joints, calc, 12, n_nodes, dt, horizon, ref_cfg, gait_file,
        sqp_iterations, solver_overrides, make_params,
        # normalized centroidal momentum ~ com velocity / yaw rate estimate
        lambda x: np.array([x[0], x[1], x[2], x[5], x[4], x[3]]), dev, dtype)
    return CentroidalMpcInterface(cfg=cfg, model=model, ocp=ocp, runtime=runtime,
                                  motion_manager=mm, n_nodes=n_nodes, dt=dt, gains=gains)


def build_wb_mpc(
    urdf_path: str,
    task_file: str,
    reference_file: str,
    gait_file: str,
    n_nodes: int | None = None,
    horizon: float | None = None,
    sqp_iterations: int | None = None,
    solver_overrides: dict | None = None,
    dt_override: float | None = None,
    *,
    device="cuda",
    dtype=torch.float32,
) -> WBMpcInterface:
    """Whole-body formulation assembly (reference `WBMpcInterface.cpp:131-199`),
    on `device` in `dtype`."""
    dev = resolve_device(device)
    probe_cfg = load_task_config(task_file, "wb", 1, 1)
    joints = mpc_joint_names(urdf_path, probe_cfg.model_settings.fixed_joint_names)
    layout = WBLayout(n_joints=len(joints))
    cfg = load_task_config(task_file, "wb", layout.state_dim, layout.input_dim)

    robot = build_robot_model(urdf_path, cfg)
    model = WholeBodyModel(robot=robot, layout=layout,
                           contact_frames=tuple(cfg.model_settings.contact_names))
    ocp = WholeBodyOcp(model=model, cfg=cfg)
    n_nodes, dt, horizon = _grid(cfg, n_nodes, horizon, dt_override)
    ref_cfg = load_reference_config(reference_file, layout.n_joints)
    calc = WBTargetCalculator(ref_cfg=ref_cfg, mpc_horizon=horizon)

    def make_params(refs: SolveReferences):
        trace.device_start("params_upload")
        x_ref = torch.as_tensor(refs.x_ref, dtype=dtype, device=dev)
        trace.device_end("params_upload")
        return make_wb_node_params(ocp, refs.swing, x_ref)

    n_j = layout.n_joints
    mm, runtime, gains = _assemble(
        cfg, model, ocp, joints, calc, 6, n_nodes, dt, horizon, ref_cfg, gait_file,
        sqp_iterations, solver_overrides, make_params,
        lambda x: x[6 + n_j: 12 + n_j], dev, dtype)
    return WBMpcInterface(cfg=cfg, model=model, ocp=ocp, runtime=runtime,
                          motion_manager=mm, n_nodes=n_nodes, dt=dt, gains=gains)
