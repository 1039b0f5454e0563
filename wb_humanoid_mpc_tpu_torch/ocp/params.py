"""NodeParams builders: host-side references (gait, swing, targets) -> the
per-node parameter tensors of the OCP.

PyTorch counterpart of `wb_humanoid_mpc_tpu/ocp/params.py`. The whole-body
builder is `ocp/wb_ocp.py::make_wb_node_params`, as in the JAX package.

The centroidal params come in two parts: the upload of its host inputs
(one flat array, `pack_centroidal_inputs`) and `centroidal_node_params`, a
function of device tensors alone, which the MPC built by
`interface.py::build_centroidal_mpc` replays as a CUDA graph;
`make_centroidal_node_params` is the two in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.models import kinematics as kin
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import NodeParams


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


SWING_ARRAYS = ("contact_flags", "z_pos", "z_vel", "proximity")


def pack_centroidal_inputs(swing, x_ref) -> np.ndarray:
    """The node params' host inputs as one flat float64 array, for one
    upload: the swing arrays `SWING_ARRAYS` of a SwingReference ([N+1, 2]
    each) and the target states x_ref [N+1, nx], each row-major, in that
    order (`unpack_centroidal_inputs` reads them back)."""
    arrays = [getattr(swing, name) for name in SWING_ARRAYS] + [x_ref]
    return np.concatenate([np.asarray(a, dtype=np.float64).ravel() for a in arrays])


def unpack_centroidal_inputs(packed: torch.Tensor, nx: int) -> tuple[torch.Tensor, ...]:
    """(contact, z_pos, z_vel, proximity, x_ref) of a packed tensor
    (`pack_centroidal_inputs`), as contiguous views of it."""
    k = len(SWING_ARRAYS)
    n1 = packed.shape[0] // (2 * k + nx)
    swing = packed[: 2 * k * n1].view(k, n1, 2).unbind(0)
    return (*swing, packed[2 * k * n1:].view(n1, nx))


def centroidal_node_params(ocp, contact: torch.Tensor, z_pos: torch.Tensor,
                           z_vel: torch.Tensor, proximity: torch.Tensor,
                           x_ref: torch.Tensor) -> NodeParams:
    """`NodeParams` of all N+1 nodes from their inputs on the device (the
    swing arrays [N+1, 2], the target states x_ref [N+1, nx]): the
    weight-compensating u_ref and the task-space link references, which
    are the links' poses and twists at the target states (reference
    `EndEffectorKinematicsQuadraticCost::getParameters`), from one
    kinematics pass over all nodes.

    Tensors in, tensors out: no host copy and no branch on a value, so a
    CUDA graph can hold it (`interface.py::build_centroidal_mpc` replays
    it every tick)."""
    model = ocp.model
    lay = model.layout
    robot = model.robot
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

    return NodeParams(contact=contact, z_pos=z_pos, z_vel=z_vel, proximity=proximity,
                      x_ref=x_ref, u_ref=u_ref, torso_ref=torso_ref)


def make_centroidal_node_params(ocp, swing, x_ref: torch.Tensor) -> NodeParams:
    """SwingReference (numpy arrays [N+1, 2]) + target states x_ref [N+1, nx]
    -> `NodeParams` of all N+1 nodes on x_ref's device, in its dtype (the
    stage terms use the first N): the swing arrays uploaded, then
    `centroidal_node_params`."""

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=x_ref.dtype,
                               device=x_ref.device)

    return centroidal_node_params(ocp, *(t(getattr(swing, name)) for name in SWING_ARRAYS),
                                  x_ref)
