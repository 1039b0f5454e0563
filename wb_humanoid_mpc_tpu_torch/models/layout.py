"""State/input layouts of both formulations: index arithmetic on tensors.

PyTorch counterpart of `wb_humanoid_mpc_tpu/models/layout.py`. Every
accessor is a slice of the last dim, so it works on batched tensors. The
`with_*` setters (JAX's `.at[].set`) return a new tensor with one slice of
the last dim replaced, the value broadcast over the leading dims.

Centroidal:
    state  x = [h_com(6, normalized momentum), q_base(6), q_joints(n)]   (12+n)
    input  u = [W_l(6), W_r(6), qd_joints(n)]                            (12+n)

Whole-body:
    state  x = [q_base(6), q_joints(n), v_base(6), v_joints(n)]          (12+2n)
    input  u = [W_l(6), W_r(6), qdd_joints(n)]                           (12+n)

q_base = [p_xyz(3), theta_zyx(3)], v_base = [world linear vel, euler rates].
Wrenches are world-frame [force(3), torque(3)] per contact.
"""

from __future__ import annotations

import dataclasses

import torch

N_CONTACTS = 2
WRENCH_DIM = 6


def _with_slice(x, lo: int, hi: int | None, val):
    """x with x[..., lo:hi] replaced by `val` (broadcast); out of place."""
    hi = x.shape[-1] if hi is None else hi
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    val = torch.broadcast_to(val, (*x.shape[:-1], hi - lo))
    return torch.cat([x[..., :lo], val, x[..., hi:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Dims and input slices shared by both formulations."""

    n_joints: int

    @property
    def input_dim(self) -> int:
        return N_CONTACTS * WRENCH_DIM + self.n_joints

    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    # --- input ---
    def contact_wrench(self, u, contact: int):
        return u[..., 6 * contact: 6 * contact + 6]

    def contact_force(self, u, contact: int):
        return u[..., 6 * contact: 6 * contact + 3]

    def contact_torque(self, u, contact: int):
        return u[..., 6 * contact + 3: 6 * contact + 6]

    def contact_wrenches(self, u):
        """[..., N_CONTACTS, 6]"""
        return u[..., : 6 * N_CONTACTS].reshape(*u.shape[:-1], N_CONTACTS, 6)

    def joint_input(self, u):
        """Joint velocities (centroidal) / accelerations (whole-body)."""
        return u[..., 6 * N_CONTACTS:]

    def with_contact_force(self, u, contact: int, force):
        return _with_slice(u, 6 * contact, 6 * contact + 3, force)

    def with_joint_input(self, u, val):
        return _with_slice(u, 6 * N_CONTACTS, None, val)


@dataclasses.dataclass(frozen=True)
class CentroidalLayout(Layout):
    """x = [h(6), q_base(6), q_j(n)]"""

    @property
    def state_dim(self) -> int:
        return 12 + self.n_joints

    def momentum(self, x):
        return x[..., 0:6]

    def base_pose(self, x):
        return x[..., 6:12]

    def base_position(self, x):
        return x[..., 6:9]

    def base_euler_zyx(self, x):
        return x[..., 9:12]

    def joint_angles(self, x):
        return x[..., 12:]

    def generalized_coordinates(self, x):
        """q = [p, theta, q_j] for the rigid-body engine."""
        return x[..., 6:]

    def with_momentum(self, x, h):
        return _with_slice(x, 0, 6, h)

    def with_base_pose(self, x, pose):
        return _with_slice(x, 6, 12, pose)

    def with_joint_angles(self, x, qj):
        return _with_slice(x, 12, None, qj)

    def assemble(self, h, base_pose, qj):
        return torch.cat([h, base_pose, qj], dim=-1)


@dataclasses.dataclass(frozen=True)
class WBLayout(Layout):
    """x = [q_base(6), q_j(n), v_base(6), v_j(n)]"""

    @property
    def state_dim(self) -> int:
        return 12 + 2 * self.n_joints

    @property
    def nq(self) -> int:
        return 6 + self.n_joints

    def base_pose(self, x):
        return x[..., 0:6]

    def base_position(self, x):
        return x[..., 0:3]

    def base_euler_zyx(self, x):
        return x[..., 3:6]

    def joint_angles(self, x):
        return x[..., 6: 6 + self.n_joints]

    def base_velocity(self, x):
        n = self.n_joints
        return x[..., 6 + n: 12 + n]

    def joint_velocities(self, x):
        return x[..., 12 + self.n_joints:]

    def generalized_coordinates(self, x):
        return x[..., : 6 + self.n_joints]

    def generalized_velocities(self, x):
        return x[..., 6 + self.n_joints:]

    def with_base_pose(self, x, pose):
        return _with_slice(x, 0, 6, pose)

    def with_joint_angles(self, x, qj):
        return _with_slice(x, 6, 6 + self.n_joints, qj)

    def assemble(self, q, v):
        return torch.cat([q, v], dim=-1)
