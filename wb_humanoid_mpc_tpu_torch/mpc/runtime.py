"""Receding-horizon MPC runtime: warm-started solves + policy interpolation.

PyTorch counterpart of `wb_humanoid_mpc_tpu/mpc/runtime.py` (ocs2's
`MPC_BASE` / `MPC_MRT_Interface` pair): `advance()` is the MPC side
(observation -> references -> warm-started SQP solve -> policy), and
`Policy.evaluate()` is the MRT side (time-interpolated state/input lookup).

The solve runs on the solver's device; everything around it is host numpy,
as in the JAX package. Per tick, the runtime moves the warm start, the node
params and the zero multipliers to the device once, reads the solve's four
scalars in one copy of a stacked tensor, and copies the solution's xs, us to
numpy once (the next warm start and `Policy.evaluate` read that copy).
Warm starting follows the reference (`mpc.coldStart false`): the previous
solution is time-shifted onto the new grid and the tail is padded by
repetition.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.refs.manager import MotionManager
from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory
from wb_humanoid_mpc_tpu_torch.utils import trace
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Policy:
    """Flattened policy (the reference's `MpcFlattenedController` analogue)."""
    t0: float
    dt: float
    xs: np.ndarray  # [N+1, nx]
    us: np.ndarray  # [N, nu]
    contact_flags: np.ndarray  # [N+1, 2]

    def evaluate(self, t: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x*, u*, contact) at time t — `MRT_BASE::evaluatePolicy` analogue."""
        N = self.us.shape[0]
        s = (t - self.t0) / self.dt
        k = int(np.clip(np.floor(s), 0, N - 1))
        a = float(np.clip(s - k, 0.0, 1.0))
        x = (1 - a) * self.xs[k] + a * self.xs[k + 1]
        u = self.us[min(int(np.clip(np.floor(s), 0, N - 1)), N - 1)]
        flags = self.contact_flags[min(k if a < 0.5 else k + 1, N)]
        return x, u, flags


@dataclasses.dataclass
class SolveStats:
    """Per-solve wall-times (reference `SqpBenchmarksPublisher.cpp:44-57`)."""
    solve_time: float
    reference_time: float
    cost: float
    g_norm: float
    defect_norm: float
    step_size: float
    # per-phase wall times; nonzero when the runtime was built with a staged
    # solver (`make_staged_sqp_solver`)
    lq_time: float = 0.0
    projection_time: float = 0.0
    riccati_time: float = 0.0
    linesearch_time: float = 0.0
    # the solve's SQP iterations, and whether it ran the recovery solver
    iterations: int = 0
    recovery: bool = False
    # the solve's record of `utils/trace.py` (spans, device intervals, idle
    # by span); None when the recorder is off
    trace: trace.Record | None = None


class MpcRuntime:
    def __init__(
        self,
        solve_fn: Callable,           # make_sqp_solver output
        motion_manager: MotionManager,
        make_node_params: Callable,   # (SolveReferences) -> NodeParams on the device
        n_nodes: int,
        dt: float,
        n_eq: int,
        default_input: np.ndarray,
        base_vel_extractor=None,   # state -> [vx, vy, vz, yaw_rate, ...] estimate
        warm_reset_g: float = 1.0,
        warm_reset_alpha: float = 0.0,
        recovery_solve_fn: Callable | None = None,
        *,
        device="cuda",
        dtype=torch.float32,
    ):
        self.solve_fn = solve_fn
        self.mm = motion_manager
        self.make_node_params = make_node_params
        self.N = n_nodes
        self.dt = dt
        self.n_eq = n_eq
        self.default_input = np.asarray(default_input)
        self.base_vel_extractor = base_vel_extractor
        # two-level solve-divergence recovery (the JAX runtime's, itself the
        # sync analogue of the reference's weight-comp fallback controller,
        # `CentroidalMpcMrtJointController.cpp:173-196,249-253`): after a solve
        # that ended with max |g| above `warm_reset_g` or accepted no step, the
        # next solve runs `recovery_solve_fn` (more SQP iterations) and, when
        # the previous solve was far off, restarts from the
        # WeightCompInitializer trajectory (ocs2 `WeightCompInitializer.cpp:66-70`).
        self.warm_reset_g = warm_reset_g
        self.warm_reset_alpha = warm_reset_alpha
        self.recovery_solve_fn = recovery_solve_fn
        self.device = resolve_device(device)
        self.dtype = dtype
        self.policy: Policy | None = None
        self._traj: tuple[np.ndarray, np.ndarray] | None = None   # host copy (xs, us)
        self._lam = None
        self._last_t: float | None = None
        self._last_g: float = 0.0
        self._last_alpha: float = 1.0
        self.n_warm_resets: int = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    def _initializer_inputs(self, cf: np.ndarray) -> np.ndarray:
        """[N, nu] WeightCompInitializer inputs per node: gravity split over
        the stance feet of that node's contact flags; joint rows zero."""
        mg = float(self.default_input[2] + self.default_input[8])
        us = np.zeros((self.N, self.default_input.shape[0]))
        for k in range(self.N):
            n_stance = float(cf[k].sum())
            if n_stance > 0:
                for i in range(2):
                    if cf[k, i] > 0.5:
                        us[k, 6 * i + 2] = mg / n_stance
        return us

    # ---- warm start ----
    def _warm_start(self, t0: float, x0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self._traj is None:
            return np.tile(x0, (self.N + 1, 1)), np.tile(self.default_input, (self.N, 1))
        shift = 0.0 if self._last_t is None else (t0 - self._last_t) / self.dt
        xs_old, us_old = self._traj
        idx = np.arange(self.N + 1) + shift
        k = np.clip(np.floor(idx).astype(int), 0, self.N - 1)
        a = np.clip(idx - k, 0.0, 1.0)[:, None]
        xs = (1 - a) * xs_old[k] + a * xs_old[np.minimum(k + 1, self.N)]
        ku = np.clip(np.floor(idx[:-1]).astype(int), 0, self.N - 1)
        return xs, us_old[ku]

    # ---- MPC advance (one observation -> one policy) ----
    def advance(self, t0: float, x_obs: np.ndarray, raw_cmd: np.ndarray,
                base_vel_estimate: np.ndarray | None = None,
                terrain_height: float = 0.0) -> SolveStats:
        record = trace.begin(self.device)
        try:
            stats = self._advance(t0, x_obs, raw_cmd, base_vel_estimate, terrain_height)
        except BaseException:
            trace.abandon(record)
            raise
        stats.trace = trace.end(record, stats.iterations, stats.recovery)
        return stats

    def _advance(self, t0, x_obs, raw_cmd, base_vel_estimate, terrain_height) -> SolveStats:
        with trace.timed("refs") as refs_span:
            dt_since = 0.0 if self._last_t is None else max(t0 - self._last_t, 1e-4)
            if base_vel_estimate is None and self.base_vel_extractor is not None:
                base_vel_estimate = np.asarray(self.base_vel_extractor(np.asarray(x_obs)))
            refs = self.mm.pre_solve(t0, x_obs, raw_cmd, dt_since,
                                     base_vel_estimate, terrain_height)
            params = self.make_node_params(refs)

        with trace.span("warm_start"):
            cf = np.asarray(refs.swing.contact_flags)[: self.N]
            # soft: the previous solve left g above warm_reset_g, or crawled ->
            # keep the shifted warm start, run the recovery solver once;
            # hard: g an order of magnitude out, or no step at all -> restart
            # from the WeightCompInitializer trajectory as well
            soft = (self._traj is not None
                    and (self._last_g > self.warm_reset_g
                         or self._last_alpha <= self.warm_reset_alpha))
            hard = (self._traj is not None
                    and (self._last_g > 10.0 * self.warm_reset_g
                         or self._last_alpha <= 0.0
                         or not np.isfinite(self._last_g)))
            recovering = soft or hard
            if hard:
                xs = np.tile(np.asarray(x_obs), (self.N + 1, 1))
                us = self._initializer_inputs(cf)
                self.n_warm_resets += 1
            else:
                xs, us = self._warm_start(t0, x_obs)
                # zero the wrench entries of swing nodes in the warm start: the
                # time shift moves stance nodes into swing slots
                us = np.array(us)
                for i in range(2):
                    us[cf[:, i] < 0.5, 6 * i: 6 * i + 6] = 0.0
            trace.device_start("upload")
            init_traj = Trajectory(xs=self._tensor(xs), us=self._tensor(us))
            # AL multipliers are node-indexed; after the receding-horizon
            # shift they are stale, so each solve restarts them
            lam = torch.zeros(self.N, self.n_eq, dtype=self.dtype, device=self.device)
            x0 = self._tensor(x_obs)

        with trace.timed("solve") as solve_span:
            use_recovery = recovering and self.recovery_solve_fn is not None
            fn = self.recovery_solve_fn if use_recovery else self.solve_fn
            out = fn(t0, x0, init_traj, params, lam)
            trace.device_end("upload")   # a graphed solve ended it after its `load`
            # the staged solver returns (solution, PhaseTimings)
            timings = None
            if hasattr(out, "traj"):
                sol = out
            else:
                sol, timings = out
            # one device -> host copy of the four scalars; it waits for the solve
            trace.device_start("download")   # a graphed solve started it at its copies
            with trace.span("stats_read"):
                cost, g_norm, defect_norm, step_size = torch.stack(
                    [sol.cost, sol.g_norm, sol.defect_norm, sol.step_size]).double().cpu().tolist()

        with trace.span("readback"):
            xs = sol.traj.xs.double().cpu().numpy()
            # that copy drained the stream and the next waits for it: the
            # trace's anchor goes between them
            trace.device_end("download", anchor=True)
            self._traj = (xs, sol.traj.us.double().cpu().numpy())
        self._lam = sol.lam
        self._last_t = t0
        self._last_g = g_norm
        self._last_alpha = step_size
        with trace.span("policy"):
            self.policy = Policy(t0=t0, dt=self.dt, xs=self._traj[0], us=self._traj[1],
                                 contact_flags=np.asarray(refs.swing.contact_flags))
        return SolveStats(
            solve_time=solve_span.seconds, reference_time=refs_span.seconds,
            cost=cost, g_norm=g_norm, defect_norm=defect_norm, step_size=step_size,
            lq_time=timings.lq if timings else 0.0,
            projection_time=timings.projection if timings else 0.0,
            riccati_time=timings.riccati if timings else 0.0,
            linesearch_time=timings.linesearch if timings else 0.0,
            iterations=int(sol.iterations), recovery=use_recovery,
        )

    def reset(self) -> None:
        self.policy = None
        self._traj = None
        self._lam = None
        self._last_t = None
        self._last_g = 0.0
        self._last_alpha = 1.0
        self.n_warm_resets = 0
        self.mm.reset()
