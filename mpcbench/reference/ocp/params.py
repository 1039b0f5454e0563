"""NodeParams builders: host-side references (gait, swing, targets) -> the
per-node parameter tensors of the OCP.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/params.py`. The whole-body
builder is `ocp/wb_ocp.py::make_wb_node_params`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mpcbench.reference.models import kinematics as kin
from mpcbench.reference.ocp.centroidal_ocp import NodeParams


def weight_comp_input(total_mass: float, gravity: float, contact_flags: torch.Tensor,
                      input_dim: int) -> torch.Tensor:
    """Nominal input: gravity-compensating stance forces split over the feet in
    contact (contact_flags [..., 2] -> u [..., input_dim], same dtype/device)."""
    n_stance = torch.clamp(contact_flags.sum(-1, keepdim=True), min=1.0)
    fz = total_mass * gravity / n_stance * contact_flags
    zeros = torch.zeros(*contact_flags.shape[:-1], 1, dtype=fz.dtype, device=fz.device)
    rest = torch.zeros(*contact_flags.shape[:-1], input_dim - 9, dtype=fz.dtype,
                       device=fz.device)
    return torch.cat([zeros, zeros, fz[..., 0:1], zeros, zeros, zeros,
                      zeros, zeros, fz[..., 1:2], rest], dim=-1)


def make_centroidal_node_params(ocp, swing, x_ref: torch.Tensor) -> NodeParams:
    """SwingReference (numpy arrays [N+1, 2]) + target states x_ref [N+1, nx]
    -> `NodeParams` of all N+1 nodes on x_ref's device, in its dtype (the
    stage terms use the first N).

    The task-space link references are the links' poses and twists at the
    target states (reference `EndEffectorKinematicsQuadraticCost::getParameters`),
    from one kinematics pass over all nodes.
    """
    model = ocp.model
    lay = model.layout
    robot = model.robot

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=x_ref.dtype,
                               device=x_ref.device)

    contact = t(swing.contact_flags)
    u_ref = weight_comp_input(robot.total_mass, robot.gravity, contact, lay.input_dim)

    ts_links = [ts.link_name for ts in ocp.cfg.task_space_costs.values()]
    if ts_links:
        fk = kin.forward_kinematics(robot, lay.generalized_coordinates(x_ref))
        v = model.generalized_velocity(x_ref, lay.joint_input(u_ref), fk)
        rows = []
        for ln in ts_links:
            R_l, p_l = kin.frame_transform(robot, fk, ln)
            tw = (kin.frame_jacobian(robot, fk, ln) @ v[..., None])[..., 0]
            rows.append(torch.cat([p_l, R_l.reshape(*R_l.shape[:-2], 9), tw], dim=-1))
        torso_ref = torch.stack(rows, dim=-2)
    else:
        torso_ref = x_ref.new_zeros(*x_ref.shape[:-1], 0, 18)

    return NodeParams(contact=contact, z_pos=t(swing.z_pos), z_vel=t(swing.z_vel),
                      proximity=t(swing.proximity), x_ref=x_ref, u_ref=u_ref,
                      torso_ref=torso_ref)
