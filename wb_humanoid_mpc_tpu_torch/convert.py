"""Build the port's model and problem data from numpy arrays.

The port's counterpart of weights is the robot model and the problem data.
These builders take plain numpy arrays (for example the fields of the JAX
package's `RobotModel`, `WBNodeParams`, centroidal `NodeParams` and
`Trajectory`, which are numpy or convert to it), so a test can feed both
packages the same data.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.models.robot.urdf import Frame, RobotModel
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import NodeParams
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams
from wb_humanoid_mpc_tpu_torch.solver.riccati import RiccatiSolution
from wb_humanoid_mpc_tpu_torch.solver.transcription import LQApprox, Trajectory
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

_ROBOT_ARRAYS = ("joint_parent_body", "joint_R", "joint_p", "joint_axis", "joint_lower",
                 "joint_upper", "joint_velocity_limit", "joint_effort_limit", "mass", "com",
                 "inertia_o", "ancestor_mask")


def _frame(name: str, f) -> Frame:
    """A frame given as an object with body/R/p attributes or a (body, R, p) tuple."""
    body, R, p = (f.body, f.R, f.p) if hasattr(f, "body") else f
    return Frame(name=name, body=int(body), R=np.array(R, dtype=np.float64),
                 p=np.array(p, dtype=np.float64))


def robot_model_from_arrays(arrays: Mapping) -> RobotModel:
    """RobotModel from a mapping with the `RobotModel` field names: the numpy
    arrays, `joint_names`, `body_names`, `frames` (name -> frame), and
    optionally `name` and `gravity`."""
    kw = {k: np.array(arrays[k]) for k in _ROBOT_ARRAYS}
    kw["joint_parent_body"] = kw["joint_parent_body"].astype(np.int32)
    kw["ancestor_mask"] = kw["ancestor_mask"].astype(bool)
    return RobotModel(
        name=str(arrays.get("name", "robot")),
        joint_names=[str(n) for n in arrays["joint_names"]],
        body_names=[str(n) for n in arrays["body_names"]],
        frames={name: _frame(name, f) for name, f in arrays["frames"].items()},
        gravity=float(arrays.get("gravity", 9.81)),
        **kw)


def _params(cls, params: Mapping, device, dtype):
    dev = resolve_device(device)
    return cls(*(torch.as_tensor(np.asarray(params[f], dtype=np.float64), dtype=dtype,
                                 device=dev) for f in cls._fields))


def node_params_from_numpy(params: Mapping, *, device="cuda",
                           dtype=torch.float32) -> WBNodeParams:
    """WBNodeParams from numpy arrays keyed by field name (leading node dim)."""
    return _params(WBNodeParams, params, device, dtype)


def centroidal_node_params_from_numpy(params: Mapping, *, device="cuda",
                                      dtype=torch.float32) -> NodeParams:
    """Centroidal `NodeParams` from numpy arrays keyed by field name (leading
    node dim; `torso_ref` [..., n_ts_links, 18])."""
    return _params(NodeParams, params, device, dtype)


def trajectory_from_numpy(xs, us, *, device="cuda", dtype=torch.float32) -> Trajectory:
    """Trajectory from numpy xs [N+1, nx] and us [N, nu]."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)

    return Trajectory(xs=t(xs), us=t(us))


def _tensors(fields, arrays, device, dtype) -> dict:
    """{field: tensor} for the attributes of `arrays` named in `fields` that
    it holds and that are not None."""
    dev = resolve_device(device)
    return {f: torch.as_tensor(np.array(getattr(arrays, f), dtype=np.float64), dtype=dtype,
                               device=dev)
            for f in fields if getattr(arrays, f, None) is not None}


def lq_from_numpy(lq, *, device="cuda", dtype=torch.float32) -> LQApprox:
    """LQApprox from an object (for example the JAX `LQApprox`) whose
    `LQApprox` attributes are arrays; attributes that are absent or None stay None."""
    return LQApprox(**_tensors(LQApprox._fields, lq, device, dtype))


def riccati_solution_from_numpy(sol, *, device="cuda", dtype=torch.float32) -> RiccatiSolution:
    """RiccatiSolution (K, k, P, p) from an object with those arrays as attributes."""
    return RiccatiSolution(**_tensors(RiccatiSolution._fields, sol, device, dtype))
