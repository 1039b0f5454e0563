"""The reference MPC: the frozen plain copy assembled as the port's
`interface.build_wb_mpc` / `build_centroidal_mpc` assemble the port, with
no CUDA graph, no kernel and no live re-tuning.

`build_reference(formulation, files, device, dtype)` loads the task,
reference and gait files of a configuration, builds the robot model, the
formulation's OCP, the eager SQP solve and its 12-iteration recovery twin,
and wires the host reference pipeline (`refs/manager.py::MotionManager`)
into an `MpcRuntime`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpcbench.reference.core.config import (
    TaskConfig,
    load_gait_library,
    load_reference_config,
    load_task_config,
)
from mpcbench.reference.models.centroidal_model import CentroidalModel
from mpcbench.reference.models.layout import CentroidalLayout, WBLayout
from mpcbench.reference.models.robot.factory import build_robot_model, mpc_joint_names
from mpcbench.reference.models.wb_model import WholeBodyModel
from mpcbench.reference.mpc.runtime import MpcRuntime
from mpcbench.reference.ocp.centroidal_ocp import CentroidalOcp
from mpcbench.reference.ocp.params import make_centroidal_node_params, weight_comp_input
from mpcbench.reference.ocp.wb_ocp import WholeBodyOcp, make_wb_node_params
from mpcbench.reference.refs.manager import MotionManager, SolveReferences
from mpcbench.reference.refs.targets import CentroidalTargetCalculator, WBTargetCalculator
from mpcbench.reference.solver.sqp import SqpSolverConfig, make_sqp_solver

RECOVERY_ITERATIONS = 12


@dataclasses.dataclass
class ReferenceMpc:
    cfg: TaskConfig
    model: object
    ocp: object
    runtime: MpcRuntime
    motion_manager: MotionManager
    n_nodes: int
    dt: float


def _arm_indices(cfg: TaskConfig, joint_names: list[str]) -> dict[str, int]:
    return {role: joint_names.index(j) for role, j in cfg.model_settings.arm_joint_names.items()
            if j in joint_names}


def build_reference(formulation: str, urdf: str, task: str, reference: str, gait: str, *,
                    device="cpu", dtype=torch.float64) -> ReferenceMpc:
    """The reference MPC of `formulation` ("wb" | "centroidal") at the task
    file's own grid (dt, horizon) and `max(sqpIteration, 2)` iterations."""
    if formulation not in ("wb", "centroidal"):
        raise ValueError(f"unknown formulation {formulation!r}")
    dev = torch.device(device)
    probe = load_task_config(task, formulation, 1, 1)
    joints = mpc_joint_names(urdf, probe.model_settings.fixed_joint_names)
    layout = (WBLayout if formulation == "wb" else CentroidalLayout)(n_joints=len(joints))
    cfg = load_task_config(task, formulation, layout.state_dim, layout.input_dim)
    robot = build_robot_model(urdf, cfg)
    ref_cfg = load_reference_config(reference, layout.n_joints)
    contacts = tuple(cfg.model_settings.contact_names)
    if formulation == "wb":
        model = WholeBodyModel(robot=robot, layout=layout, contact_frames=contacts)
        ocp = WholeBodyOcp(model=model, cfg=cfg)
        make_params, joint_start = make_wb_node_params, 6
        n_j = layout.n_joints

        def base_vel(x):
            return x[6 + n_j: 12 + n_j]
    else:
        model = CentroidalModel(robot=robot, layout=layout, contact_frames=contacts,
                                srbm=(cfg.centroidal_model_type == 1),
                                nominal_joint_angles=tuple(ref_cfg.default_joint_state.tolist()))
        ocp = CentroidalOcp(model=model, cfg=cfg)
        make_params, joint_start = make_centroidal_node_params, 12

        def base_vel(x):
            # normalized centroidal momentum ~ com velocity / yaw rate estimate
            return np.array([x[0], x[1], x[2], x[5], x[4], x[3]])
    dt = cfg.sqp.dt
    n_nodes = int(round(cfg.mpc.time_horizon / dt))
    horizon = n_nodes * dt
    calc = (WBTargetCalculator if formulation == "wb" else CentroidalTargetCalculator)(
        ref_cfg=ref_cfg, mpc_horizon=horizon)
    mm = MotionManager(
        ref_cfg=ref_cfg, swing_cfg=cfg.swing, gait_map=load_gait_library(gait),
        target_calculator=calc, horizon=horizon, n_nodes=n_nodes,
        joint_start_index=joint_start, arm_indices=_arm_indices(cfg, joints),
        phase_transition_stance_time=cfg.model_settings.phase_transition_stance_time)
    solver_cfg = SqpSolverConfig(n_nodes=n_nodes, dt=dt,
                                 sqp_iterations=max(cfg.sqp.sqp_iteration, 2))
    bp = ocp.barrier_params(dev, dtype)
    solve = make_sqp_solver(ocp, model.flow_map, bp, solver_cfg, device=dev)
    recovery = make_sqp_solver(
        ocp, model.flow_map, bp,
        dataclasses.replace(solver_cfg, sqp_iterations=RECOVERY_ITERATIONS), device=dev)

    def node_params(refs: SolveReferences):
        return make_params(ocp, refs.swing, torch.as_tensor(refs.x_ref, dtype=dtype, device=dev))

    u_default = weight_comp_input(robot.total_mass, robot.gravity,
                                  torch.ones(2, dtype=torch.float64), layout.input_dim).numpy()
    runtime = MpcRuntime(
        solve_fn=solve, motion_manager=mm, make_node_params=node_params, n_nodes=n_nodes,
        dt=dt, n_eq=ocp.n_eq, default_input=u_default, base_vel_extractor=base_vel,
        recovery_solve_fn=recovery, device=dev, dtype=dtype)
    return ReferenceMpc(cfg=cfg, model=model, ocp=ocp, runtime=runtime, motion_manager=mm,
                        n_nodes=n_nodes, dt=dt)
