"""Swing-foot z-trajectory planner (host-side; exports solver-ready arrays).

Faithful re-implementation of the reference planner
(reference `SwingTrajectoryPlanner.cpp:87-300`, `SplineCpg.cpp:37-62`,
`CubicSpline.cpp:37-70`): per swing phase, two cubic Hermite splines through
liftoff -> apex -> touchdown, plus an "impact proximity factor" spline that
scales foot velocity costs near touchdown. Stance phases hold terrain height
with proximity factor 1.

The planner's output for the solver is `SwingReference`: per-node,
per-foot (z pos/vel/acc reference, impact proximity, contact flag) arrays of
static shape — the solver-ready product of this branchy host logic.

A numpy copy of `wb_humanoid_mpc_tpu/refs/swing.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.core.config import SwingTrajectoryConfig
from wb_humanoid_mpc_tpu_torch.refs.gait import ModeSchedule, mode_to_contact_flags


class CubicSpline:
    """Hermite cubic on normalized time (reference `CubicSpline.cpp:37-56`)."""

    def __init__(self, t0, p0, v0, t1, p1, v1):
        assert t1 > t0
        self.t0, self.t1, self.dt = t0, t1, t1 - t0
        dp = p1 - p0
        dv = v1 - v0
        self.c0 = p0
        self.c1 = v0 * self.dt
        self.c2 = -(3.0 * v0 + dv) * self.dt + 3.0 * dp
        self.c3 = (2.0 * v0 + dv) * self.dt - 2.0 * dp

    def _tn(self, t):
        return (t - self.t0) / self.dt

    def position(self, t):
        tn = self._tn(t)
        return ((self.c3 * tn + self.c2) * tn + self.c1) * tn + self.c0

    def velocity(self, t):
        tn = self._tn(t)
        return (3.0 * self.c3 * tn * tn + 2.0 * self.c2 * tn + self.c1) / self.dt

    def acceleration(self, t):
        tn = self._tn(t)
        return (6.0 * self.c3 * tn + 2.0 * self.c2) / (self.dt * self.dt)


class SplineCpg:
    """Two cubics through liftoff -> (mid, 0) -> touchdown
    (reference `SplineCpg.cpp:37-41`)."""

    def __init__(self, t0, p0, v0, mid_height, t1, p1, v1):
        self.mid_time = 0.5 * (t0 + t1)
        self.left = CubicSpline(t0, p0, v0, self.mid_time, mid_height, 0.0)
        self.right = CubicSpline(self.mid_time, mid_height, 0.0, t1, p1, v1)

    def _sel(self, t):
        return self.left if t < self.mid_time else self.right

    def position(self, t):
        return self._sel(t).position(t)

    def velocity(self, t):
        return self._sel(t).velocity(t)

    def acceleration(self, t):
        return self._sel(t).acceleration(t)


@dataclasses.dataclass
class _Phase:
    t_start: float
    t_end: float
    height: SplineCpg
    proximity: SplineCpg
    in_contact: bool


def _swing_scaling(t_start, t_end, swing_time_scale):
    return min(1.0, (t_end - t_start) / swing_time_scale)


class SwingTrajectoryPlanner:
    """(reference `SwingTrajectoryPlanner.cpp:87+`)"""

    N_FEET = 2

    def __init__(self, config: SwingTrajectoryConfig):
        self.cfg = config
        self._phases: list[list[_Phase]] = [[], []]
        self._event_times = np.zeros(0)

    def update(self, mode_schedule: ModeSchedule, terrain_height: float = 0.0) -> None:
        cfg = self.cfg
        event_times = mode_schedule.event_times
        modes = mode_schedule.mode_sequence
        n_phases = len(modes)
        flags = mode_to_contact_flags(modes)  # [n_phases, 2]

        self._event_times = event_times.copy()
        lift_h = terrain_height
        touch_h = terrain_height + cfg.touch_down_height_offset

        for leg in range(self.N_FEET):
            phases: list[_Phase] = []
            leg_flags = flags[:, leg]
            for p in range(n_phases):
                t_start = event_times[p - 1] if p > 0 else -np.inf
                t_end = event_times[p] if p < len(event_times) else np.inf
                if leg_flags[p]:
                    # stance: constant height, proximity 1
                    h = SplineCpg(0.0, lift_h, 0.0, lift_h, 1.0, lift_h, 0.0)
                    pr = SplineCpg(0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0)
                    phases.append(_Phase(t_start, t_end, h, pr, True))
                    continue

                # swing: locate surrounding contact phases
                # (reference findIndex, SwingTrajectoryPlanner.cpp:236-262)
                start_idx = -1
                for ip in range(p - 1, -1, -1):
                    if leg_flags[ip]:
                        start_idx = ip
                        break
                final_idx = n_phases - 1
                for ip in range(p + 1, n_phases):
                    if leg_flags[ip]:
                        final_idx = ip - 1
                        break
                if start_idx < 0:
                    raise RuntimeError(f"take-off time for first swing of foot {leg} undefined")
                if final_idx >= n_phases - 1:
                    raise RuntimeError(f"touch-down time for last swing of foot {leg} undefined")

                ts = event_times[start_idx]
                tf = event_times[final_idx]
                prev_contact = leg_flags[p - 1] if p > 0 else False
                next_contact = leg_flags[p + 1] if p + 1 < n_phases else False
                s = _swing_scaling(ts, tf, cfg.swing_time_scale)
                mid_val = cfg.impact_proximity_factor_mid_point_value

                if prev_contact and next_contact:
                    # single-phase swing (reference :131-141)
                    mid_h = min(lift_h, touch_h) + s * cfg.swing_height
                    h = SplineCpg(ts, lift_h, s * cfg.lift_off_velocity,
                                  mid_h, tf, touch_h, s * cfg.touch_down_velocity)
                    pr = SplineCpg(ts, 1.0, s * cfg.impact_proximity_factor_lift_off_velocity,
                                   mid_val, tf, 1.0,
                                   s * cfg.impact_proximity_factor_touch_down_velocity)
                elif prev_contact:
                    # just left the ground, stays in air (reference :142-152)
                    mid_h = lift_h + cfg.swing_height
                    h = SplineCpg(ts, lift_h, cfg.lift_off_velocity, mid_h, tf, mid_h, 0.0)
                    pr = SplineCpg(ts, 1.0, cfg.impact_proximity_factor_lift_off_velocity,
                                   mid_val, tf, mid_val, 0.0)
                elif next_contact:
                    # in the air, impacting next mode (reference :153-163)
                    mid_h = touch_h + cfg.swing_height
                    h = SplineCpg(ts, mid_h, 0.0, mid_h, tf, touch_h, cfg.touch_down_velocity)
                    pr = SplineCpg(ts, mid_val, 0.0, mid_val, tf, 1.0,
                                   cfg.impact_proximity_factor_touch_down_velocity)
                else:
                    # airborne before, during, after (reference :164-175)
                    mid_h = touch_h + cfg.swing_height
                    h = SplineCpg(ts, mid_h, 0.0, mid_h, tf, mid_h, 0.0)
                    pr = SplineCpg(ts, mid_val, 0.0, mid_val, tf, mid_val, 0.0)
                phases.append(_Phase(t_start, t_end, h, pr, False))
            self._phases[leg] = phases

    def _phase_at(self, leg: int, t: float) -> _Phase:
        idx = int(np.searchsorted(self._event_times, t, side="right"))
        idx = min(idx, len(self._phases[leg]) - 1)
        return self._phases[leg][idx]

    def z_position(self, leg: int, t: float) -> float:
        ph = self._phase_at(leg, t)
        return float(ph.height.position(t)) if not ph.in_contact else float(ph.height.position(0.0))

    def z_velocity(self, leg: int, t: float) -> float:
        ph = self._phase_at(leg, t)
        return float(ph.height.velocity(t)) if not ph.in_contact else 0.0

    def z_acceleration(self, leg: int, t: float) -> float:
        ph = self._phase_at(leg, t)
        return float(ph.height.acceleration(t)) if not ph.in_contact else 0.0

    def impact_proximity(self, leg: int, t: float) -> float:
        ph = self._phase_at(leg, t)
        return float(ph.proximity.position(t)) if not ph.in_contact else 1.0

    def contact_flag(self, leg: int, t: float) -> bool:
        return self._phase_at(leg, t).in_contact


@dataclasses.dataclass
class SwingReference:
    """Static-shape per-node reference arrays consumed by the OCP.

    This replaces `HumanoidPreComputation`'s per-node swing caches
    (reference `HumanoidPreComputation.cpp:96+`).
    """

    contact_flags: np.ndarray   # [N+1, 2] float (1.0 in contact)
    z_pos: np.ndarray           # [N+1, 2]
    z_vel: np.ndarray           # [N+1, 2]
    z_acc: np.ndarray           # [N+1, 2]
    proximity: np.ndarray       # [N+1, 2]


def sample_swing_reference(planner: SwingTrajectoryPlanner, times: np.ndarray) -> SwingReference:
    N1 = len(times)
    out = SwingReference(
        contact_flags=np.zeros((N1, 2)),
        z_pos=np.zeros((N1, 2)),
        z_vel=np.zeros((N1, 2)),
        z_acc=np.zeros((N1, 2)),
        proximity=np.zeros((N1, 2)),
    )
    for k, t in enumerate(times):
        for leg in range(2):
            out.contact_flags[k, leg] = 1.0 if planner.contact_flag(leg, t) else 0.0
            out.z_pos[k, leg] = planner.z_position(leg, t)
            out.z_vel[k, leg] = planner.z_velocity(leg, t)
            out.z_acc[k, leg] = planner.z_acceleration(leg, t)
            out.proximity[k, leg] = planner.impact_proximity(leg, t)
    return out
