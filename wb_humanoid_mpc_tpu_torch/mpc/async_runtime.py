"""Async MPC/MRT pipeline: a solver thread decoupled from the control loop.

PyTorch counterpart of `wb_humanoid_mpc_tpu/mpc/async_runtime.py`: the
reference's solver-thread / control-thread split
(`CentroidalMpcMrtJointController.cpp:93-97, 235-260`: a `solverWorker`
thread runs `advanceMpc` in a loop while the 500 Hz control loop reads the
newest policy through `MPC_MRT_Interface`), over the seqlock buffers of
`wb_humanoid_mpc_tpu_torch.native` (the `ThreadSafe<T>` analogue, reference
`robot_core/ThreadSafe.h:6-30`) for the observation and policy planes.

- `MrtPipeline`: a real thread and the seqlock exchange; the control loop
  never blocks on a solve. A solve that raises or returns a non-finite cost
  sets the failure flag (reference `:249-253`, "The solver has failed to
  update!!"), and the controller then gets no policy (its weight-compensating
  fallback). The solver thread selects the runtime's CUDA device before its
  first operation and launches the kernels on that thread's current stream.
  On the card the runtime's solves are CUDA graphs, captured by this thread
  at their first call while the control loop runs: the capture is
  thread-local (`solver/graphs.py`), so the controller's work on its own
  stream in the other thread neither waits for it nor breaks it.
- `PolicyObserver`: a read-only subscriber of the policy plane.
- `SimulatedLatencyMpc`: deterministic variant on the sim clock: a solve
  dispatched at sim time t becomes active at t + solve_latency.
"""

from __future__ import annotations

import threading
import time as _time

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.mpc.runtime import MpcRuntime, Policy, SolveStats
from wb_humanoid_mpc_tpu_torch.native import ThreadSafeBuffer
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


class _PolicyCodec:
    """Flatten/unflatten a Policy through a fixed-size seqlock buffer."""

    def __init__(self, n_nodes: int, nx: int, nu: int):
        self.N, self.nx, self.nu = n_nodes, nx, nu
        # [seq_valid, t0, dt] + xs + us + contact flags
        self.size = 3 + (n_nodes + 1) * nx + n_nodes * nu + (n_nodes + 1) * 2

    def pack(self, policy: Policy, seq: float) -> np.ndarray:
        out = np.empty(self.size)
        out[0] = seq
        out[1] = policy.t0
        out[2] = policy.dt
        i = 3
        for arr in (policy.xs, policy.us, policy.contact_flags):
            flat = np.asarray(arr, dtype=np.float64).ravel()
            out[i:i + flat.size] = flat
            i += flat.size
        return out

    def unpack(self, buf: np.ndarray) -> tuple[float, Policy | None]:
        seq = float(buf[0])
        if seq <= 0:
            return seq, None
        N, nx, nu = self.N, self.nx, self.nu
        i = 3
        xs = buf[i:i + (N + 1) * nx].reshape(N + 1, nx)
        i += (N + 1) * nx
        us = buf[i:i + N * nu].reshape(N, nu)
        i += N * nu
        flags = buf[i:i + (N + 1) * 2].reshape(N + 1, 2)
        return seq, Policy(t0=float(buf[1]), dt=float(buf[2]),
                           xs=xs.copy(), us=us.copy(), contact_flags=flags.copy())


class MrtPipeline:
    """Solver thread + lock-free policy/observation exchange.

    `device` must be the runtime's own; it is a parameter only so that the
    pipeline, like every entry point of the package, defaults to the card,
    raises with none, and runs on the CPU only when the caller asks."""

    def __init__(self, runtime: MpcRuntime, nx: int, cmd_dim: int = 4, *, device="cuda"):
        self.device = resolve_device(device)
        if runtime.device != self.device:
            raise ValueError(f"MrtPipeline on {self.device}: the runtime solves on "
                             f"{runtime.device}")
        self.runtime = runtime
        self.nx = nx
        self.cmd_dim = cmd_dim
        self._obs_buf = ThreadSafeBuffer(2 + nx + cmd_dim)  # [seq, t, x, cmd]
        self._codec = _PolicyCodec(runtime.N, nx, int(runtime.default_input.shape[0]))
        self._pol_buf = ThreadSafeBuffer(self._codec.size)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.failed = False
        self.error: BaseException | None = None
        self.solve_count = 0
        self.last_stats: SolveStats | None = None
        self._obs_seq = 0.0

    # ---- control side ----
    def push_observation(self, t: float, x: np.ndarray, cmd: np.ndarray) -> None:
        self._obs_seq += 1.0
        buf = np.concatenate([[self._obs_seq, t], np.asarray(x, dtype=float),
                              np.asarray(cmd, dtype=float)])
        self._obs_buf.write(buf)

    def get_policy(self) -> Policy | None:
        """Latest policy, or None before the first solve or after a solver
        failure (the controller maps None to the weight-compensating fallback,
        reference `CentroidalMpcMrtJointController.cpp:170-196`). Never
        blocks."""
        if self.failed:
            return None
        _, pol = self._codec.unpack(self._pol_buf.read())
        return pol

    # ---- solver thread ----
    def _fail(self, why: str) -> None:
        print(f"[mrt] the solver has failed to update!! ({why})")
        self.failed = True

    def _worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        last_seq = 0.0
        while not self._stop.is_set():
            buf = self._obs_buf.read()
            seq = float(buf[0])
            if seq <= last_seq:      # no new observation yet
                _time.sleep(1e-4)
                continue
            last_seq = seq
            t = float(buf[1])
            x = buf[2:2 + self.nx]
            cmd = buf[2 + self.nx:]
            try:
                stats = self.runtime.advance(t, x, cmd)
            except Exception as e:   # solver hard failure
                self.error = e
                self._fail(repr(e))
                return
            if not np.isfinite(stats.cost):
                self._fail("non-finite cost")
                return
            self.last_stats = stats
            self.solve_count += 1
            self._pol_buf.write(self._codec.pack(self.runtime.policy, float(self.solve_count)))

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True, name="mpc-solver")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Ask the solver thread to stop after its current solve and join it;
        raises if it is still running after `timeout` seconds."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"the solver thread did not stop within {timeout} s")
            self._thread = None


class PolicyObserver:
    """Read-only policy subscriber (the reference's `MRTPolicySubscriber`,
    `MRTPolicySubscriber.h:41-90`): follows a `MrtPipeline`'s policy plane
    without being able to push observations; reads never block."""

    def __init__(self, pipeline: MrtPipeline):
        self._buf = pipeline._pol_buf
        self._codec = pipeline._codec

    def get_policy(self) -> Policy | None:
        """Latest policy, or None before the first solve."""
        _, pol = self._codec.unpack(self._buf.read())
        return pol

    def evaluate(self, t: float):
        """(x*, u*, contact) at time t, or None before the first policy."""
        pol = self.get_policy()
        return None if pol is None else pol.evaluate(t)


class SimulatedLatencyMpc:
    """Deterministic async semantics on the sim clock.

    `tick(t, x, cmd)` is called every control step. A solve is dispatched
    when none is in flight and at least `1/mpc_frequency` has elapsed since
    the previous dispatch; its policy becomes visible at
    `t_dispatch + solve_latency`. Between activations the control loop keeps
    using the previous policy.
    """

    def __init__(self, runtime: MpcRuntime, mpc_frequency: float, solve_latency: float):
        self.runtime = runtime
        self.period = 1.0 / mpc_frequency
        self.latency = solve_latency
        self._pending = None          # (t_ready, Policy, SolveStats)
        self._last_dispatch = -np.inf
        self.active_policy: Policy | None = None
        self.stats: list[SolveStats] = []
        self.overruns = 0             # dispatches later than 1.5 periods after the last

    def _activate(self, t: float) -> None:
        if self._pending is not None and t >= self._pending[0]:
            self.active_policy = self._pending[1]
            self.stats.append(self._pending[2])
            self._pending = None

    def tick(self, t: float, x: np.ndarray, cmd: np.ndarray) -> Policy | None:
        self._activate(t)
        if self._pending is None and t - self._last_dispatch >= self.period - 1e-9:
            stats = self.runtime.advance(t, x, cmd)
            self._pending = (t + self.latency, self.runtime.policy, stats)
            if t - self._last_dispatch > self.period * 1.5 and np.isfinite(self._last_dispatch):
                self.overruns += 1
            self._last_dispatch = t
        self._activate(t)
        return self.active_policy
