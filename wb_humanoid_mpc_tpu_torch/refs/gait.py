"""Gait / mode-schedule subsystem (host-side control logic).

Replaces the reference gait stack (reference `gait/GaitSchedule.{h,cpp}`,
`gait/ModeSequenceTemplate.h:47-70`, `gait/MotionPhaseDefinition.h:46-83`).
This runs on host once per solve (it is branchy control logic, not compute);
its *products* — per-node contact flags and swing references — are exported
as fixed-shape arrays consumed by the solver.

Modes ({LF, RF} contact): FLY=0, RF=1, LF=2, STANCE=3.

A numpy copy of `wb_humanoid_mpc_tpu/refs/gait.py`: the PyTorch port imports
nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.core.config import ModeSequenceTemplate

FLY, RF, LF, STANCE = 0, 1, 2, 3

_MODE_FLAGS = np.array(
    [[False, False], [False, True], [True, False], [True, True]], dtype=bool
)


def mode_to_contact_flags(mode) -> np.ndarray:
    """mode -> [left_in_contact, right_in_contact]
    (reference `MotionPhaseDefinition.h:57-75`)."""
    return _MODE_FLAGS[np.asarray(mode)]


def contact_flags_to_mode(flags) -> int:
    """(reference `MotionPhaseDefinition.h:81-83`)"""
    return int(flags[1]) + 2 * int(flags[0])


@dataclasses.dataclass
class ModeSchedule:
    """event_times[K], mode_sequence[K+1] (ocs2 `ModeSchedule` equivalent)."""

    event_times: np.ndarray
    mode_sequence: np.ndarray

    def mode_at(self, t: float) -> int:
        idx = int(np.searchsorted(self.event_times, t, side="right"))
        return int(self.mode_sequence[idx])

    def contact_flags_at(self, t: float) -> np.ndarray:
        return mode_to_contact_flags(self.mode_at(t))

    def contact_flags_at_times(self, times: np.ndarray) -> np.ndarray:
        """[T, 2] bool contact flags at each query time."""
        idx = np.searchsorted(self.event_times, times, side="right")
        return mode_to_contact_flags(self.mode_sequence[idx])

    def copy(self) -> "ModeSchedule":
        return ModeSchedule(self.event_times.copy(), self.mode_sequence.copy())


class GaitSchedule:
    """Receding-horizon gait container (reference `GaitSchedule.h:42-81`).

    Semantics mirror the reference exactly: `get_mode_schedule(t0, tf)` trims
    history (keeping one pre-t0 phase forced to STANCE), tiles the current
    template up to tf, and appends a final STANCE
    (reference `GaitSchedule.cpp:84-109,115-144`).
    """

    def __init__(self, init_schedule: ModeSchedule, template: ModeSequenceTemplate,
                 phase_transition_stance_time: float = 0.0):
        self._schedule = init_schedule.copy()
        self._template = template
        self._phase_transition_stance_time = float(phase_transition_stance_time)

    @property
    def current_template(self) -> ModeSequenceTemplate:
        return self._template

    def insert_mode_sequence_template(self, template: ModeSequenceTemplate,
                                      start_time: float, final_time: float) -> None:
        """(reference `GaitSchedule.cpp:52-79`)"""
        self._template = template
        times = list(self._schedule.event_times)
        modes = list(self._schedule.mode_sequence)

        index = int(np.searchsorted(times, start_time, side="left"))
        del times[index:]
        del modes[index + 1:]

        stance_time = self._phase_transition_stance_time
        if modes and modes[-1] == STANCE:
            stance_time = 0.0
        if stance_time > 0.0:
            times.append(start_time)
            modes.append(STANCE)

        self._schedule = ModeSchedule(np.array(times), np.array(modes, dtype=np.int64))
        self._tile(start_time + stance_time, final_time)

    def get_mode_schedule(self, lower_bound: float, upper_bound: float) -> ModeSchedule:
        """(reference `GaitSchedule.cpp:84-109`)"""
        times = list(self._schedule.event_times)
        modes = list(self._schedule.mode_sequence)
        index = int(np.searchsorted(times, lower_bound, side="left"))
        if index > 0:
            del times[: index - 1]
            del modes[: index - 1]
            modes[0] = STANCE

        tiling_start = upper_bound if not times else times[-1]
        if times:
            del times[-1:]
        del modes[-1:]

        self._schedule = ModeSchedule(np.array(times), np.array(modes, dtype=np.int64))
        self._tile(tiling_start, upper_bound)
        return self._schedule.copy()

    def _tile(self, start_time: float, final_time: float) -> None:
        """(reference `GaitSchedule.cpp:115-144`)"""
        tmpl_times = self._template.switching_times
        tmpl_modes = self._template.mode_sequence
        times = list(self._schedule.event_times)
        modes = list(self._schedule.mode_sequence)
        if len(tmpl_modes) == 0:
            return
        if times and start_time <= times[-1]:
            raise RuntimeError("template tiling start not after last event time")
        times.append(start_time)
        while times[-1] < final_time:
            for i in range(len(tmpl_modes)):
                modes.append(int(tmpl_modes[i]))
                times.append(times[-1] + float(tmpl_times[i + 1] - tmpl_times[i]))
        modes.append(STANCE)
        self._schedule = ModeSchedule(np.array(times), np.array(modes, dtype=np.int64))


def default_gait_schedule(init_modes: np.ndarray, init_times: np.ndarray,
                          template: ModeSequenceTemplate,
                          phase_transition_stance_time: float = 0.0) -> GaitSchedule:
    return GaitSchedule(
        ModeSchedule(np.asarray(init_times, dtype=float),
                     np.asarray(init_modes, dtype=np.int64)),
        template,
        phase_transition_stance_time,
    )
