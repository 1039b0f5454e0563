"""Operator command plane: velocity/gait/pose command sources.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/tools/commands.py` (host
Python; `pygame` is imported only when the joystick source starts).

Replaces the reference's DDS command topics + publishers
(`WalkingVelocityCommand.idl`, `VelocityCommandKeyboardPublisher.cpp:51`,
`GaitKeyboardPublisher.cpp:53,89`, xbox/GUI publishers in `remote_control/`):
the data plane is an in-process thread-safe mailbox (`CommandBus`) that the
MPC loop polls each solve; sources (keyboard thread, joystick poller,
programmatic scripts) write into it.
"""

from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np


@dataclasses.dataclass
class WalkingVelocityCommand:
    """(reference `msg/WalkingVelocityCommand.idl:1-28`) — normalized units:
    vx, vy in [-1, 1], pelvis_height in meters (0 = default), wz in [-1, 1]."""
    linear_velocity_x: float = 0.0
    linear_velocity_y: float = 0.0
    desired_pelvis_height: float = 0.0
    angular_velocity_z: float = 0.0

    def to_vector(self) -> np.ndarray:
        return np.array([
            np.clip(self.linear_velocity_x, -1.0, 1.0),
            np.clip(self.linear_velocity_y, -1.0, 1.0),
            self.desired_pelvis_height,
            np.clip(self.angular_velocity_z, -1.0, 1.0),
        ])


class CommandBus:
    """Thread-safe latest-value mailbox (the `ThreadSafe<T>` + topic pattern,
    reference `robot_core/ThreadSafe.h:6-30` + `Ros2ProceduralMpcMotionManager.cpp:53-62`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._velocity = WalkingVelocityCommand()
        self._gait_request: str | None = None
        self._pose_request: np.ndarray | None = None

    def set_velocity(self, cmd: WalkingVelocityCommand) -> None:
        with self._lock:
            self._velocity = cmd

    def get_velocity(self) -> np.ndarray:
        with self._lock:
            return self._velocity.to_vector()

    def request_gait(self, name: str) -> None:
        with self._lock:
            self._gait_request = name

    def pop_gait_request(self) -> str | None:
        with self._lock:
            g, self._gait_request = self._gait_request, None
            return g

    def request_pose(self, delta: np.ndarray) -> None:
        """[dx, dy, dz, dyaw_deg] base-frame pose delta (reference keyboard
        pose command node, `CentroidalMpcKeyboardPoseCommandNode.cpp:68-86`)."""
        with self._lock:
            self._pose_request = np.asarray(delta, dtype=float).copy()

    def pop_pose_request(self) -> np.ndarray | None:
        with self._lock:
            p, self._pose_request = self._pose_request, None
            return p

    def drain_into(self, motion_manager) -> None:
        """Forward queued gait/pose requests to a MotionManager (call once
        per solve from the control loop). Unknown gait names are logged and
        dropped — a typo on the interactive console must not crash the
        control loop mid-run."""
        g = self.pop_gait_request()
        if g is not None:
            try:
                motion_manager.request_gait(g)
            except KeyError as e:
                print(f"[commands] ignoring unknown gait: {e}", file=sys.stderr)
        p = self.pop_pose_request()
        if p is not None:
            motion_manager.set_pose_command(p)


class KeyboardCommandSource:
    """stdin command reader (reference keyboard publishers): lines like
    `vel 0.5 0 0`, `gait trot`, `height 0.7`. Runs on a daemon thread."""

    def __init__(self, bus: CommandBus, stream=None):
        self.bus = bus
        self.stream = stream or sys.stdin
        self._thread: threading.Thread | None = None

    def handle_line(self, line: str) -> None:
        parts = line.strip().split()
        if not parts:
            return
        if parts[0] == "vel" and len(parts) >= 4:
            self.bus.set_velocity(WalkingVelocityCommand(
                float(parts[1]), float(parts[2]), 0.0, float(parts[3])))
        elif parts[0] == "height" and len(parts) >= 2:
            v = self.bus._velocity
            self.bus.set_velocity(WalkingVelocityCommand(
                v.linear_velocity_x, v.linear_velocity_y, float(parts[1]),
                v.angular_velocity_z))
        elif parts[0] == "gait" and len(parts) >= 2:
            self.bus.request_gait(parts[1])
        elif parts[0] == "pose" and len(parts) >= 5:
            # pose dx dy dz dyaw_deg (reference pose command node semantics)
            self.bus.request_pose(np.array([float(p) for p in parts[1:5]]))
        elif parts[0] == "stop":
            self.bus.set_velocity(WalkingVelocityCommand())

    def start(self) -> None:
        def loop():
            for line in self.stream:
                self.handle_line(line)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()


class XboxCommandSource:
    """pygame joystick poller (reference `xbox_walking_command_publisher.py:38-72`).
    Gated on pygame availability; maps left stick -> vx/vy, right stick x -> wz,
    with reconnect polling."""

    def __init__(self, bus: CommandBus, poll_hz: float = 25.0):
        self.bus = bus
        self.poll_hz = poll_hz
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.connected = False  # mirrored by the velocity GUI's LED

    def start(self) -> bool:
        try:
            import pygame  # noqa: F401
        except ImportError:
            return False

        def loop():
            import time

            import pygame
            pygame.init()
            pygame.joystick.init()
            js = None
            while not self._stop.is_set():
                if js is None:
                    # reconnect polling (reference :63-67)
                    self.connected = False
                    pygame.joystick.quit()
                    pygame.joystick.init()
                    if pygame.joystick.get_count() > 0:
                        js = pygame.joystick.Joystick(0)
                        js.init()
                        self.connected = True
                    time.sleep(1.0)
                    continue
                pygame.event.pump()
                self.bus.set_velocity(WalkingVelocityCommand(
                    linear_velocity_x=-js.get_axis(1),
                    linear_velocity_y=-js.get_axis(0),
                    desired_pelvis_height=0.0,
                    angular_velocity_z=-js.get_axis(3),
                ))
                time.sleep(1.0 / self.poll_hz)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
