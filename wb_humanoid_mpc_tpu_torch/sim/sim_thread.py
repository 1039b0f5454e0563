"""Threaded MuJoCo runtime: dedicated physics thread + render thread.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/sim/sim_thread.py`. It
re-provides the reference's sim/render/control thread architecture
(`robot_runtime/mujoco_sim_interface/src/MujocoSimInterface.cpp:393+`):

- `MujocoSimThread` — a dedicated physics thread stepping `mjData` at
  dt = 0.5 ms. Each tick it reads the latest `JointAction` and writes the
  resulting `RobotState` through seqlock buffers (the `ThreadSafe<T>`
  analogue, reference `robot_core/ThreadSafe.h:6-30`), applies PD+ff
  torques, and tracks the reference's sim metrics: sim fps, per-tick
  drift, cumulative drift and realtime factor
  (`MujocoSimInterface.cpp:338-352`).
- `MujocoRenderer` — a render thread (the reference's GLFW window thread,
  `MujocoRenderer.cpp`). Headless-first: it snapshots the sim state at a
  fixed fps and renders offscreen via `mujoco.Renderer` (EGL/OSMesa) when a
  GL context exists, degrading to qpos snapshots otherwise so the thread
  lifecycle is exercised even without a display.
- `run_threaded_robot_sim` — the reference's `CentroidalMpcRobotSim` /
  `WBMpcRobotSim` process shape (`CentroidalMpcRobotSim.cpp:45-165`):
  physics thread + solver thread (`MrtPipeline`) + the control loop at
  `mrt_frequency` in the calling thread, all exchanging state through
  lock-free buffers. The solver thread runs the MPC on the interface's
  device (the card by default); physics, rendering and the buffers are host
  code.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time

import numpy as np

from wb_humanoid_mpc_tpu_torch.mpc.controller import JointAction
from wb_humanoid_mpc_tpu_torch.native import ThreadSafeBuffer
from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface, RobotState
from wb_humanoid_mpc_tpu_torch.tools.benchmarks import FPSTracker


@dataclasses.dataclass
class SimMetrics:
    """(reference `MujocoSimInterface.cpp:338-352`)"""
    sim_fps: float = 0.0
    tick_drift_s: float = 0.0       # last tick: wall elapsed - sim dt
    cumulative_drift_s: float = 0.0
    realtime_factor: float = 0.0    # sim time advanced / wall time elapsed
    ticks: int = 0


class MujocoSimThread:
    """Physics thread over a `MujocoSimInterface`.

    Actions in / states out go through seqlock buffers so the control loop
    and the physics tick never block each other (reference
    `RobotHWInterfaceBase.h:13-45` double buffering). `realtime=True` paces
    the thread to the sim clock; `realtime=False` free-runs (as fast as the
    host can step — used by tests and faster-than-realtime evaluation).
    """

    def __init__(self, sim: MujocoSimInterface, realtime: bool = True):
        self.sim = sim
        self.realtime = realtime
        # Optional pacing gate: the physics thread pauses once sim time
        # reaches this bound. Faster-than-realtime harnesses advance it one
        # MRT period at a time so physics can never outrun the controller
        # (the wall clock provides the same back-pressure in realtime mode).
        self.allowed_sim_time = float("inf")
        n = sim.n_joints
        self._nq = 7 + n
        self._nv = 6 + n
        # [seq, q_des, qd_des, kp, kd, ff]
        self._act_buf = ThreadSafeBuffer(1 + 5 * n)
        # [seq, time, qpos, qvel, contact(2), n_resets]
        self._state_buf = ThreadSafeBuffer(1 + 1 + self._nq + self._nv + 2 + 1)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.metrics = SimMetrics()
        self._fps = FPSTracker()
        self._act_seq = 0.0
        self._publish_state(0.0)

    # ---- control side ----
    def write_action(self, action: JointAction) -> None:
        self._act_seq += 1.0
        buf = np.concatenate([[self._act_seq], action.q_des, action.qd_des,
                              action.kp, action.kd, action.ff_effort])
        self._act_buf.write(buf)

    def read_state(self) -> RobotState:
        buf = self._state_buf.read()
        nq, nv = self._nq, self._nv
        i = 2
        qpos = buf[i:i + nq]; i += nq
        qvel = buf[i:i + nv]; i += nv
        contacts = buf[i:i + 2]; i += 2
        quat = qpos[3:7]
        Rm = _quat_to_mat(quat)
        return RobotState(
            time=float(buf[1]),
            base_position=qpos[0:3].copy(),
            base_quat_wxyz=quat.copy(),
            base_lin_vel_local=Rm.T @ qvel[0:3],
            base_ang_vel_local=qvel[3:6].copy(),
            joint_positions=qpos[7:].copy(),
            joint_velocities=qvel[6:].copy(),
            contact_flags=[bool(contacts[0] > 0.5), bool(contacts[1] > 0.5)],
        )

    @property
    def n_resets(self) -> int:
        return int(self._state_buf.read()[-1])

    # ---- physics thread ----
    def _read_action(self) -> JointAction | None:
        buf = self._act_buf.read()
        if buf[0] <= 0.0:
            return None
        n = self.sim.n_joints
        parts = [buf[1 + k * n: 1 + (k + 1) * n] for k in range(5)]
        return JointAction(q_des=parts[0], qd_des=parts[1], kp=parts[2],
                           kd=parts[3], ff_effort=parts[4])

    def _publish_state(self, seq: float) -> None:
        d = self.sim.data
        flags = self.sim._foot_contacts()
        buf = np.concatenate([
            [seq, d.time], d.qpos, d.qvel,
            [1.0 if flags[0] else 0.0, 1.0 if flags[1] else 0.0],
            [float(self.sim.n_resets)],
        ])
        self._state_buf.write(buf)

    def _worker(self) -> None:
        import mujoco

        dt = self.sim.dt
        t_wall0 = _time.perf_counter()
        t_sim0 = self.sim.data.time
        seq = 0.0
        prev_wall = t_wall0
        while not self._stop.is_set():
            if self.sim.data.time >= self.allowed_sim_time:
                _time.sleep(1e-5)
                continue
            action = self._read_action()
            if action is not None:
                self.sim.apply_action_and_step(action, n_steps=1)
            else:
                # no controller attached yet: free-fall physics, as the
                # reference sim does before the first joint action arrives
                self.sim.data.ctrl[:] = 0.0
                mujoco.mj_step(self.sim.model, self.sim.data)
            seq += 1.0
            self._publish_state(seq)

            now = _time.perf_counter()
            self.metrics.ticks += 1
            self.metrics.sim_fps = self._fps.tick(now)
            self.metrics.tick_drift_s = (now - prev_wall) - dt
            prev_wall = now
            wall_elapsed = now - t_wall0
            sim_elapsed = self.sim.data.time - t_sim0
            self.metrics.cumulative_drift_s = wall_elapsed - sim_elapsed
            self.metrics.realtime_factor = (
                sim_elapsed / wall_elapsed if wall_elapsed > 0 else 0.0)

            if self.realtime and self.metrics.cumulative_drift_s < 0:
                _time.sleep(min(-self.metrics.cumulative_drift_s, dt))

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mujoco-sim")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def _quat_to_mat(quat_wxyz: np.ndarray) -> np.ndarray:
    import mujoco

    R = np.zeros(9)
    mujoco.mju_quat2Mat(R, np.asarray(quat_wxyz, dtype=float))
    return R.reshape(3, 3)


class MujocoRenderer:
    """Render thread (reference `MujocoRenderer` GLFW thread,
    `MujocoSimInterface.cpp:393+`).

    Pulls the sim thread's state at `fps` and renders offscreen frames when
    a GL context is available. Without GL (this sandbox) it still runs the
    full thread lifecycle, recording qpos snapshots, so downstream code and
    tests exercise the same architecture; `frames` is then empty and
    `snapshots` holds the trajectory.
    """

    def __init__(self, sim_thread: MujocoSimThread, fps: float = 30.0,
                 width: int = 640, height: int = 480, max_frames: int = 300):
        self.sim_thread = sim_thread
        self.fps = fps
        self.max_frames = max_frames
        self.frames: list[np.ndarray] = []
        self.snapshots: list[np.ndarray] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._renderer = None
        self._model = sim_thread.sim.model
        try:
            import mujoco

            self._renderer = mujoco.Renderer(self._model, height=height,
                                             width=width)
            self.gl_available = True
        except Exception:
            self.gl_available = False

    def _worker(self) -> None:
        import mujoco

        data = mujoco.MjData(self._model)
        period = 1.0 / self.fps
        while not self._stop.is_set():
            st = self.sim_thread.read_state()
            qpos = np.concatenate([st.base_position, st.base_quat_wxyz,
                                   st.joint_positions])
            if len(self.snapshots) < self.max_frames:
                self.snapshots.append(qpos)
            if self.gl_available and len(self.frames) < self.max_frames:
                try:
                    data.qpos[:] = qpos
                    mujoco.mj_forward(self._model, data)
                    self._renderer.update_scene(data)
                    self.frames.append(self._renderer.render().copy())
                except Exception:
                    self.gl_available = False
            _time.sleep(period)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mujoco-render")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def run_threaded_robot_sim(
    mpc_interface,
    controller,
    sim: MujocoSimInterface,
    duration: float,
    mrt_frequency: float = 500.0,
    command_fn=None,
    realtime: bool = False,
    render_fps: float = 0.0,
):
    """Three-thread robot sim (reference `CentroidalMpcRobotSim.cpp:45-165`):
    physics thread (2 kHz) + solver thread (`MrtPipeline`, on the MPC
    interface's device) + this control loop at `mrt_frequency`. Returns
    (`ClosedLoopLog`, `SimMetrics`, the renderer or None).

    `realtime=False` paces the control loop to the SIM clock (reads states
    until sim time advances one MRT period) so tests run faster than wall
    clock while preserving the threaded dataflow.
    """
    from wb_humanoid_mpc_tpu_torch.mpc.async_runtime import MrtPipeline
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import (
        ClosedLoopLog,
        check_devices,
        full_action,
        mpc_joint_indices,
        observer,
    )

    model = mpc_interface.model
    runtime = mpc_interface.runtime
    check_devices(runtime, controller)
    mpc_joint_idx = mpc_joint_indices(model, sim)
    observe = observer(model, mpc_joint_idx)

    dt_mrt = 1.0 / mrt_frequency
    sim_thread = MujocoSimThread(sim, realtime=realtime)
    if not realtime:
        # faster-than-realtime: let physics run at most one MRT period ahead
        sim_thread.allowed_sim_time = sim.data.time + dt_mrt
    pipeline = MrtPipeline(runtime, nx=model.layout.state_dim, device=runtime.device)
    renderer = MujocoRenderer(sim_thread, fps=render_fps) if render_fps > 0 else None

    times, base_pos, heights, qjs, stats = [], [], [], [], []
    sim_thread.start()
    pipeline.start()
    if renderer is not None:
        renderer.start()
    try:
        t_end = sim.data.time + duration
        next_tick = sim.data.time
        while True:
            rs = sim_thread.read_state()
            if rs.time >= t_end:
                break
            if rs.time < next_tick:
                _time.sleep(dt_mrt * 0.1 if realtime else 1e-5)
                continue
            next_tick = rs.time + dt_mrt
            if not realtime:
                sim_thread.allowed_sim_time = next_tick + dt_mrt
            x_obs = observe(rs)
            cmd = np.zeros(4) if command_fn is None else np.asarray(command_fn(rs.time))
            pipeline.push_observation(rs.time, x_obs, cmd)
            policy = pipeline.get_policy()
            if pipeline.last_stats is not None and (
                    not stats or stats[-1] is not pipeline.last_stats):
                stats.append(pipeline.last_stats)
            action_mpc = controller.compute(rs.time, x_obs, policy)
            sim_thread.write_action(full_action(controller, action_mpc, sim.n_joints,
                                                mpc_joint_idx))
            times.append(rs.time)
            base_pos.append(rs.base_position.copy())
            heights.append(rs.base_position[2])
            qjs.append(rs.joint_positions.copy())
    finally:
        pipeline.stop()
        sim_thread.stop()
        if renderer is not None:
            renderer.stop()

    return ClosedLoopLog(
        times=np.asarray(times),
        base_positions=np.asarray(base_pos),
        base_heights=np.asarray(heights),
        joint_positions=np.asarray(qjs),
        solve_stats=stats,
        n_resets=sim.n_resets,
    ), sim_thread.metrics, renderer
