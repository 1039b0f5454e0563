"""Target-trajectory calculators (velocity/pose command -> state references).

Host-side numpy; faithful to the reference:
- base helpers: `TargetTrajectoriesCalculatorBase.cpp:40-165` (velocity filter,
  local->global transform, base pose integration, time-to-target estimate)
- centroidal: `CentroidalMpcTargetTrajectoriesCalculator.cpp:87-158`
  (3-knot momentum+pose trajectory at t0, t0+0.7T, t0+T)
- whole-body: `WBMpcTargetTrajectoriesCalculator.cpp:80-135` (pose + joints +
  base velocity targets, zero joint velocity)

A numpy copy of `wb_humanoid_mpc_tpu/refs/targets.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpcbench.reference.core.config import ReferenceConfig


@dataclasses.dataclass
class TargetTrajectories:
    """Knot-based target trajectory (ocs2 `TargetTrajectories` equivalent)."""

    times: np.ndarray    # [K]
    states: np.ndarray   # [K, nx]

    def sample(self, query_times: np.ndarray) -> np.ndarray:
        """Piecewise-linear interpolation, constant extrapolation (matches
        ocs2 `LinearInterpolation` semantics)."""
        q = np.clip(query_times, self.times[0], self.times[-1])
        out = np.empty((len(query_times), self.states.shape[1]))
        for j in range(self.states.shape[1]):
            out[:, j] = np.interp(q, self.times, self.states[:, j])
        return out


class AlphaFilter:
    """Break-frequency low-pass (reference `BreakFrequencyAlphaFilter.h:39-68`);
    wall-clock-free variant: the caller passes dt explicitly."""

    def __init__(self, break_frequency_hz: float, y0: np.ndarray):
        self._break_dt = 1.0 / (2.0 * np.pi * break_frequency_hz)
        self._y = np.asarray(y0, dtype=float).copy()

    def __call__(self, x: np.ndarray, dt: float) -> np.ndarray:
        alpha = dt / (dt + self._break_dt)
        self._y = alpha * np.asarray(x, dtype=float) + (1 - alpha) * self._y
        return self._y.copy()


@dataclasses.dataclass
class _BaseCalculator:
    ref_cfg: ReferenceConfig
    mpc_horizon: float

    def __post_init__(self):
        self._vel_filter_state = np.zeros(4)

    def scale_command(self, raw_cmd: np.ndarray) -> np.ndarray:
        """[-1,1]-normalized (vx, vy, pelvis_height, wz) -> physical units
        (reference `ProceduralMpcMotionManager.cpp:74-80`)."""
        c = np.asarray(raw_cmd, dtype=float).copy()
        c[0] *= self.ref_cfg.max_displacement_velocity_x
        c[1] *= self.ref_cfg.max_displacement_velocity_y
        c[3] *= self.ref_cfg.max_rotation_velocity
        return c

    def filter_and_transform_to_global(self, cmd_local: np.ndarray, euler_z: float,
                                       filter_alpha: float = 0.8) -> np.ndarray:
        """(reference `TargetTrajectoriesCalculatorBase.cpp:115-130`)"""
        self._vel_filter_state = (self._vel_filter_state * filter_alpha
                                  + np.asarray(cmd_local, dtype=float) * (1 - filter_alpha))
        f = self._vel_filter_state
        out = f.copy()
        out[0] = np.cos(euler_z) * f[0] - np.sin(euler_z) * f[1]
        out[1] = np.sin(euler_z) * f[0] + np.cos(euler_z) * f[1]
        return out

    @staticmethod
    def integrate_base_pose(pose: np.ndarray, avg_vel: np.ndarray, height: float,
                            dt: float) -> np.ndarray:
        """(reference `TargetTrajectoriesCalculatorBase.cpp:137-151`)"""
        out = pose.copy()
        out[0] += avg_vel[0] * dt
        out[1] += avg_vel[1] * dt
        out[2] = height
        out[3] += avg_vel[2] * dt
        out[4] = 0.0
        out[5] = 0.0
        return out

    def estimate_time_to_target(self, delta: np.ndarray) -> float:
        rotation_time = abs(delta[3]) / self.ref_cfg.target_rotation_velocity
        displacement = float(np.hypot(delta[0], delta[1]))
        return max(rotation_time, displacement / self.ref_cfg.target_displacement_velocity)

    def _delta_base_target(self, cmd: np.ndarray, current_pose: np.ndarray,
                           max_delta_height: float = 0.5) -> np.ndarray:
        """Pose-delta command [dx, dy, dz, dyaw_deg] (base frame) -> absolute
        6-dim base pose target (reference
        `TargetTrajectoriesCalculatorBase.cpp:71-95` getDeltaBaseTarget)."""
        ez = current_pose[3]
        gx = np.cos(ez) * cmd[0] - np.sin(ez) * cmd[1]
        gy = np.sin(ez) * cmd[0] + np.cos(ez) * cmd[1]
        target = np.zeros(6)
        target[0] = current_pose[0] + gx
        target[1] = current_pose[1] + gy
        target[2] = self.ref_cfg.default_base_height + np.clip(
            cmd[2], -max_delta_height, max_delta_height)
        target[3] = current_pose[3] + np.deg2rad(cmd[3])
        return target

    def position_to_targets(self, pose_cmd: np.ndarray, t0: float,
                            x_init: np.ndarray, pose_slice: slice,
                            nx: int) -> TargetTrajectories:
        """Pose-delta command -> 2-knot state trajectory (reference
        `CentroidalMpcTargetTrajectoriesCalculator.cpp:57-80`
        commandedPositionToTargetTrajectories; the keyboard pose-command node
        `CentroidalMpcKeyboardPoseCommandNode.cpp:68-86` feeds this)."""
        current = np.asarray(x_init[pose_slice], dtype=float).copy()
        current[4] = 0.0
        current[5] = 0.0
        target = self._delta_base_target(np.asarray(pose_cmd, dtype=float), current)
        t_reach = t0 + self.estimate_time_to_target(target - current)
        states = np.zeros((2, nx))
        for i, p in enumerate((current, target)):
            states[i, pose_slice] = p
            # joints at default on both knots
            j0 = pose_slice.stop
            states[i, j0:j0 + len(self.ref_cfg.default_joint_state)] = (
                self.ref_cfg.default_joint_state)
        return TargetTrajectories(np.array([t0, t_reach]), states)



@dataclasses.dataclass
class CentroidalTargetCalculator(_BaseCalculator):
    """state layout [h(6), pose(6), q_j(n)]"""

    def velocity_to_targets(self, scaled_cmd: np.ndarray, t0: float,
                            x_init: np.ndarray, base_vel_xy_yaw: np.ndarray | None = None
                            ) -> TargetTrajectories:
        """(reference `CentroidalMpcTargetTrajectoriesCalculator.cpp:87-158`).

        scaled_cmd = (vx_local, vy_local, pelvis_height, wz) in physical units;
        base_vel_xy_yaw: current base (vx, vy, wz) estimate for the blend leg
        (the reference derives it from Ab^-1 h; callers may pass it directly).
        """
        pose = x_init[6:12].copy()
        pose[4] = 0.0
        pose[5] = 0.0

        cmd_g = self.filter_and_transform_to_global(scaled_cmd, pose[3])

        target_momentum = np.zeros(6)
        target_momentum[0] = cmd_g[0]
        target_momentum[1] = cmd_g[1]
        target_momentum[5] = cmd_g[3]  # note: reference divides by mass; with
        # normalized momentum state the yaw-rate entry is already small — we
        # keep the literal reference expression below.

        if base_vel_xy_yaw is None:
            base_vel_xy_yaw = np.array([x_init[0], x_init[1], x_init[5]])

        avg = np.array([
            0.5 * (base_vel_xy_yaw[0] + cmd_g[0]),
            0.5 * (base_vel_xy_yaw[1] + cmd_g[1]),
            0.5 * (base_vel_xy_yaw[2] + cmd_g[3]),
        ])
        height = cmd_g[2] if abs(cmd_g[2]) > 1e-9 else self.ref_cfg.default_base_height
        pose[2] = height
        t_mid = 0.7 * self.mpc_horizon
        pose_mid = self.integrate_base_pose(pose, avg, height, t_mid)
        avg_final = np.array([cmd_g[0], cmd_g[1], cmd_g[3]])
        pose_final = self.integrate_base_pose(pose_mid, avg_final, height,
                                              self.mpc_horizon - t_mid)

        nx = 12 + len(self.ref_cfg.default_joint_state)
        states = np.zeros((3, nx))
        for i, p in enumerate((pose, pose_mid, pose_final)):
            states[i, 0:6] = target_momentum
            states[i, 6:12] = p
            states[i, 12:] = self.ref_cfg.default_joint_state
        times = np.array([t0, t0 + t_mid, t0 + self.mpc_horizon])
        return TargetTrajectories(times, states)



@dataclasses.dataclass
class WBTargetCalculator(_BaseCalculator):
    """state layout [pose(6), q_j(n), v_base(6), v_j(n)]
    (reference `WBMpcTargetTrajectoriesCalculator.cpp:80-135`)."""

    def velocity_to_targets(self, scaled_cmd: np.ndarray, t0: float,
                            x_init: np.ndarray) -> TargetTrajectories:
        n_j = len(self.ref_cfg.default_joint_state)
        pose = x_init[0:6].copy()
        pose[4] = 0.0
        pose[5] = 0.0
        cmd_g = self.filter_and_transform_to_global(scaled_cmd, pose[3])

        v_base = x_init[6 + n_j: 12 + n_j]
        avg = np.array([
            0.5 * (v_base[0] + cmd_g[0]),
            0.5 * (v_base[1] + cmd_g[1]),
            0.5 * (v_base[3] + cmd_g[3]),
        ])
        height = cmd_g[2] if abs(cmd_g[2]) > 1e-9 else self.ref_cfg.default_base_height
        pose[2] = height
        t_mid = 0.7 * self.mpc_horizon
        pose_mid = self.integrate_base_pose(pose, avg, height, t_mid)
        avg_final = np.array([cmd_g[0], cmd_g[1], cmd_g[3]])
        pose_final = self.integrate_base_pose(pose_mid, avg_final, height,
                                              self.mpc_horizon - t_mid)

        target_base_vel = np.array([cmd_g[0], cmd_g[1], 0.0, cmd_g[3], 0.0, 0.0])
        nx = 12 + 2 * n_j
        states = np.zeros((3, nx))
        for i, p in enumerate((pose, pose_mid, pose_final)):
            states[i, 0:6] = p
            states[i, 6:6 + n_j] = self.ref_cfg.default_joint_state
            states[i, 6 + n_j:12 + n_j] = target_base_vel
        times = np.array([t0, t0 + t_mid, t0 + self.mpc_horizon])
        return TargetTrajectories(times, states)


def apply_arm_swing(x_ref: np.ndarray, phase: np.ndarray, local_vx_cmd: float,
                    joint_start: int, arm_indices: dict[str, int]) -> np.ndarray:
    """Procedural arm-swing reference
    (reference `SwitchedModelReferenceManager.cpp:110-135`): shoulder-pitch and
    elbow targets oscillate with the gait phase, scaled by commanded forward
    velocity. `phase` is per-node in [0,1); x_ref is [N+1, nx] (modified copy
    returned)."""
    out = np.array(x_ref, copy=True)
    factor = np.sin(2 * np.pi * (phase - 0.15)) * local_vx_cmd
    for key, sign in (("left_shoulder_y", -1.0), ("right_shoulder_y", +1.0),
                      ("left_elbow_y", -1.0), ("right_elbow_y", +1.0)):
        idx = arm_indices.get(key)
        if idx is None:
            continue
        out[:, joint_start + idx] += sign * 0.15 * factor
    return out


def gait_phase_variable(mode_schedule, times: np.ndarray) -> np.ndarray:
    """Phase in [0,1): 0..0.5 over an LF phase, 0.5..1 over an RF phase,
    frozen during stance (reference `SwitchedModelReferenceManager.cpp:62-78`)."""
    from mpcbench.reference.refs.gait import LF, RF

    ev = mode_schedule.event_times
    out = np.zeros(len(times))
    for k, t in enumerate(times):
        i = int(np.searchsorted(ev, t, side="right"))
        t_prev = ev[i - 1] if i > 0 else t - 1.0
        t_next = ev[i] if i < len(ev) else t + 1.0
        mode = int(mode_schedule.mode_sequence[i])
        frac = (t - t_prev) / max(t_next - t_prev, 1e-9)
        if mode == LF:
            out[k] = 0.5 * frac
        elif mode == RF:
            out[k] = 0.5 + 0.5 * frac
        else:
            prev_mode = mode_schedule.mode_at(t_prev - 0.01)
            out[k] = 0.5 if prev_mode == LF else 0.0
    return out
