"""Whole-body problem setup from a robot asset directory.

An asset directory holds `<name>.urdf` and a WB `task.info` (the port ships
`assets/humanoid23/`, the G1-width model, and `assets/toy_biped/`).
`build_wb_problem` loads them the way the JAX package's `_wb_setup` does
(`__graft_entry__.py`) and builds the warm-start problem of `bench.py`: all
nodes at the initial state, gravity-compensating inputs, zero multipliers.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.core.config import TaskConfig, load_task_config
from wb_humanoid_mpc_tpu_torch.models.layout import WBLayout
from wb_humanoid_mpc_tpu_torch.models.robot.factory import build_robot_model, mpc_joint_names
from wb_humanoid_mpc_tpu_torch.models.wb_model import WholeBodyModel
from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.ocp.params import weight_comp_input
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams, WholeBodyOcp, make_wb_node_params
from wb_humanoid_mpc_tpu_torch.refs.swing import SwingReference
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

ASSETS = Path(__file__).resolve().parent / "assets"


def asset_files(asset_dir) -> tuple[str, str]:
    """(urdf path, task.info path) of an asset directory."""
    d = Path(asset_dir)
    return str(d / f"{d.name}.urdf"), str(d / "task.info")


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
