"""Reference manager + procedural motion manager (host-side control plane).

Combines the roles of the reference's `SwitchedModelReferenceManager`
(`SwitchedModelReferenceManager.cpp:140-155` modifyReferences),
`ProceduralMpcMotionManager` (velocity filtering, 7-state gait FSM with
hysteresis + dwell, `ProceduralMpcMotionManager.cpp:119-160`, FSM table
`ProceduralMpcMotionManager.h:110-118`) and `GaitScheduleUpdater`
(earliest-switch heuristic `GaitScheduleUpdater.cpp:44-68`).

Per MPC solve it produces the static-shape reference bundle (`SolveReferences`)
consumed by the solver: mode schedule products, swing arrays, nominal
state trajectory with arm swing.

A numpy copy of `wb_humanoid_mpc_tpu/refs/manager.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.core.config import (
    ModeSequenceTemplate,
    ReferenceConfig,
    SwingTrajectoryConfig,
)
from wb_humanoid_mpc_tpu_torch.refs.gait import STANCE, ModeSchedule, default_gait_schedule
from wb_humanoid_mpc_tpu_torch.refs.swing import (
    SwingReference,
    SwingTrajectoryPlanner,
    sample_swing_reference,
)
from wb_humanoid_mpc_tpu_torch.refs.targets import (
    AlphaFilter,
    apply_arm_swing,
    gait_phase_variable,
)


@dataclasses.dataclass
class GaitModeState:
    """One row of the gait FSM table (reference `ProceduralMpcMotionManager.h:110-118`)."""
    gait: str
    min_lin_vel_cmd: float
    max_lin_vel_cmd: float
    min_ang_vel_cmd: float
    max_ang_vel_cmd: float
    lin_vel_error_thresh: float
    ang_vel_error_thresh: float


GAIT_FSM_TABLE = [
    GaitModeState("stance", -0.1, 0.1, -0.1, 0.1, 10.0, 10.0),
    GaitModeState("slow_walk", 0.05, 0.3, 0.05, 0.2, 0.05, 0.05),
    GaitModeState("walk", 0.25, 0.5, 0.15, 0.35, 0.05, 0.05),
    GaitModeState("slower_trot", 0.45, 0.7, 0.3, 0.55, 0.1, 0.1),
    GaitModeState("slow_trot", 0.65, 0.9, 0.5, 0.7, 0.2, 0.2),
    GaitModeState("trot", 0.8, 1.3, 0.65, 10.0, 0.2, 0.2),
    GaitModeState("run", 1.2, 10.0, 0.65, 10.0, 0.2, 0.2),
]


@dataclasses.dataclass
class SolveReferences:
    """Per-solve reference bundle with static shapes."""
    mode_schedule: ModeSchedule
    swing: SwingReference
    x_ref: np.ndarray          # [N+1, nx]
    gait_name: str
    terrain_height: float


class MotionManager:
    """Velocity-command-driven reference pipeline for one formulation."""

    def __init__(
        self,
        ref_cfg: ReferenceConfig,
        swing_cfg: SwingTrajectoryConfig,
        gait_map: dict[str, ModeSequenceTemplate],
        target_calculator,           # CentroidalTargetCalculator | WBTargetCalculator
        horizon: float,
        n_nodes: int,
        joint_start_index: int,      # index of first joint angle in the state
        arm_indices: dict[str, int] | None = None,
        phase_transition_stance_time: float = 0.0,
        command_filter_hz: float = 5.0,
    ):
        self.ref_cfg = ref_cfg
        self.gait_map = gait_map
        self.calc = target_calculator
        self.horizon = horizon
        self.n_nodes = n_nodes
        self.joint_start = joint_start_index
        self.arm_indices = arm_indices or {}
        self._phase_transition_stance_time = phase_transition_stance_time
        self._command_filter_hz = command_filter_hz
        self._swing_cfg = swing_cfg
        self.reset()

    def reset(self) -> None:
        """Restore initial gait schedule / FSM / filter state (fresh run)."""
        ref_cfg = self.ref_cfg
        self.gait_schedule = default_gait_schedule(
            ref_cfg.initial_mode_schedule_modes,
            ref_cfg.initial_mode_schedule_times,
            ref_cfg.default_template,
            self._phase_transition_stance_time,
        )
        self.swing_planner = SwingTrajectoryPlanner(self._swing_cfg)
        self.cmd_filter = AlphaFilter(self._command_filter_hz, np.zeros(4))
        if hasattr(self.calc, "_vel_filter_state"):
            self.calc._vel_filter_state = np.zeros(4)
        self.fsm_mode = 0
        self.current_gait = "stance"
        self.last_gait = "stance"
        self.last_gait_change_time = -1.0
        self._gait_request: str | None = None
        self._pose_cmd: np.ndarray | None = None
        self._pose_targets = None

    # ---- operator command plane ----
    def request_gait(self, name: str) -> None:
        """Operator gait override (reference `GaitKeyboardPublisher.cpp:53,89`
        -> `GaitScheduleUpdaterRos2`): applied at the next pre_solve, takes
        precedence over the velocity FSM until the FSM changes mode again."""
        if name not in self.gait_map:
            raise KeyError(f"unknown gait {name!r}; have {sorted(self.gait_map)}")
        self._gait_request = name

    def set_pose_command(self, pose_delta: np.ndarray) -> None:
        """Pose-delta target [dx, dy, dz, dyaw_deg] (reference
        `CentroidalMpcKeyboardPoseCommandNode.cpp:68-86`): overrides the
        velocity targets until a nonzero velocity command arrives."""
        self._pose_cmd = np.asarray(pose_delta, dtype=float).copy()
        self._pose_targets = None

    # ---- gait FSM (reference ProceduralMpcMotionManager.cpp:86-160) ----
    def _update_gait_fsm(self, t: float, cmd: np.ndarray, base_vel: np.ndarray) -> None:
        cfg = GAIT_FSM_TABLE[self.fsm_mode]
        if t <= self.last_gait_change_time + 0.2:
            return

        faster_requested = (abs(cmd[0]) > cfg.max_lin_vel_cmd or abs(cmd[1]) > cfg.max_lin_vel_cmd
                            or abs(cmd[3]) > cfg.max_ang_vel_cmd)
        within_speed = (abs(base_vel[0]) > cfg.max_lin_vel_cmd - cfg.lin_vel_error_thresh
                        or abs(base_vel[1]) > cfg.max_lin_vel_cmd - cfg.lin_vel_error_thresh
                        or abs(base_vel[3]) > cfg.max_ang_vel_cmd - cfg.ang_vel_error_thresh)
        slower_requested = (abs(cmd[0]) < cfg.min_lin_vel_cmd and abs(cmd[1]) < cfg.min_lin_vel_cmd
                            and abs(cmd[3]) < cfg.min_ang_vel_cmd)
        slow_enough = (abs(base_vel[0]) < cfg.min_lin_vel_cmd + cfg.lin_vel_error_thresh
                       and abs(base_vel[1]) < cfg.min_lin_vel_cmd + cfg.lin_vel_error_thresh
                       and abs(cmd[3]) < cfg.min_ang_vel_cmd + cfg.ang_vel_error_thresh)

        if faster_requested and within_speed and self.fsm_mode < len(GAIT_FSM_TABLE) - 1:
            self.fsm_mode += 1
            self.current_gait = GAIT_FSM_TABLE[self.fsm_mode].gait
            self.last_gait_change_time = t
        elif slower_requested and slow_enough and self.fsm_mode > 0:
            self.fsm_mode -= 1
            self.current_gait = GAIT_FSM_TABLE[self.fsm_mode].gait
            self.last_gait_change_time = t

    def _update_gait_schedule(self, t0: float, tf: float) -> None:
        """GaitScheduleUpdater heuristic (reference `GaitScheduleUpdater.cpp:44-68`)."""
        if self.current_gait == self.last_gait:
            return
        template = self.gait_map[self.current_gait]
        horizon = tf - t0
        earliest = 0.7 * tf + 0.3 * t0
        ms = self.gait_schedule.get_mode_schedule(t0, tf + horizon)
        idx = int(np.searchsorted(ms.event_times, earliest, side="right"))
        if idx >= len(ms.event_times):
            next_event = tf
        else:
            # Pick the first boundary whose last SWING phase (skipping any
            # stance phases in between) differs from the template's first
            # mode: inserting an LF-first template after "... LF, STANCE"
            # chains two same-foot swings with only a brief stance between
            # (observed to topple the robot at the 1.2 s horizon — the old
            # check only looked at the phase immediately before the boundary,
            # which the interleaved STANCE satisfied vacuously). Extends the
            # reference's LF-alignment heuristic (`GaitScheduleUpdater.cpp:55-65`).
            template_first = int(template.mode_sequence[0])
            seq = list(ms.mode_sequence)
            next_event = None
            for j in range(idx, len(ms.event_times)):
                prev_swing = next(
                    (int(m) for m in reversed(seq[:j + 1]) if int(m) != STANCE),
                    None)
                if prev_swing is None or prev_swing != template_first:
                    next_event = float(ms.event_times[j])
                    break
            if next_event is None:
                next_event = float(ms.event_times[-1])
        self.gait_schedule.insert_mode_sequence_template(
            template, next_event, next_event + 1.5 * horizon)
        self.last_gait = self.current_gait

    # ---- per-solve entry point (preSolverRun + modifyReferences) ----
    def pre_solve(self, t0: float, x_init: np.ndarray, raw_cmd: np.ndarray,
                  dt_since_last: float, base_vel_estimate: np.ndarray | None = None,
                  terrain_height: float = 0.0) -> SolveReferences:
        tf = t0 + self.horizon
        scaled = self.calc.scale_command(raw_cmd)
        filtered = self.cmd_filter(scaled, max(dt_since_last, 1e-4))

        if base_vel_estimate is None:
            base_vel_estimate = np.zeros(6)
        if self._gait_request is not None:
            # operator override (GaitKeyboardPublisher path)
            self.current_gait = self._gait_request
            self.fsm_mode = next(
                (i for i, row in enumerate(GAIT_FSM_TABLE)
                 if row.gait == self._gait_request), self.fsm_mode)
            self.last_gait_change_time = t0
            self._gait_request = None
        else:
            self._update_gait_fsm(t0, filtered, base_vel_estimate)
        self._update_gait_schedule(t0, tf)

        # mode schedule over extended window (reference modifyReferences: [t0-T, tf+T])
        ms = self.gait_schedule.get_mode_schedule(t0 - self.horizon, tf + self.horizon)
        # Snap switch times to the shooting grid: ocs2 inserts event times into
        # the discretization (timeDiscretizationWithEvents); with a fixed-size
        # grid we instead quantize events to node boundaries so each
        # shooting interval carries a single consistent contact mode. Without
        # this, constraints/dynamics straddle switches and the SQP residual
        # floors at the phase-mismatch level.
        dt_grid = self.horizon / self.n_nodes
        snapped = t0 + np.round((ms.event_times - t0) / dt_grid) * dt_grid
        # enforce strict monotonicity after rounding
        for i in range(1, len(snapped)):
            if snapped[i] <= snapped[i - 1]:
                snapped[i] = snapped[i - 1] + dt_grid
        ms = ModeSchedule(snapped, ms.mode_sequence.copy())
        self.swing_planner.update(ms, terrain_height)

        times = t0 + np.linspace(0.0, self.horizon, self.n_nodes + 1)
        swing = sample_swing_reference(self.swing_planner, times)

        # pose-command mode: hold the 2-knot pose target until a nonzero
        # velocity command clears it (reference pose command node semantics)
        if self._pose_cmd is not None and np.abs(scaled[[0, 1, 3]]).max() > 1e-6:
            self._pose_cmd = None
            self._pose_targets = None
        if self._pose_cmd is not None:
            if self._pose_targets is None:
                nx = len(x_init)
                pose_slice = slice(self.joint_start - 6, self.joint_start)
                self._pose_targets = self.calc.position_to_targets(
                    self._pose_cmd, t0, np.asarray(x_init), pose_slice, nx)
            targets = self._pose_targets
        else:
            targets = self.calc.velocity_to_targets(filtered, t0, np.asarray(x_init))
        x_ref = targets.sample(times)

        # arm swing (reference SwitchedModelReferenceManager.cpp:110-135)
        if self.arm_indices:
            phase = gait_phase_variable(ms, times)
            euler_z = self._state_euler_z(x_init)
            local_vx = (np.cos(euler_z) * filtered[0] + np.sin(euler_z) * filtered[1])
            x_ref = apply_arm_swing(x_ref, phase, local_vx, self.joint_start, self.arm_indices)

        return SolveReferences(mode_schedule=ms, swing=swing, x_ref=x_ref,
                               gait_name=self.current_gait, terrain_height=terrain_height)

    def _state_euler_z(self, x: np.ndarray) -> float:
        # joint_start - 3 = index of theta_z for both layouts
        return float(x[self.joint_start - 3])
