"""Dummy-sim closed loop: integrator plant driven by the MPC policy.

PyTorch counterpart of `wb_humanoid_mpc_tpu/sim/dummy.py` (the headless
equivalent of the reference's `MRT_ROS_Dummy_Loop` + dummy-sim node): at the
MRT rate the plant state advances by rolling out the model dynamics under the
policy input (the reference's `TimeTriggeredRollout` semantics), and at the
MPC rate a new solve is triggered.

The plant state is float64 numpy between steps, as in the JAX package; each
step runs `rk4_step(flow, ...)` on the solver's device, in its dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.mpc.runtime import MpcRuntime, SolveStats
from wb_humanoid_mpc_tpu_torch.solver.transcription import rk4_step


@dataclasses.dataclass
class DummySimLog:
    times: np.ndarray          # [T]
    states: np.ndarray         # [T, nx]
    inputs: np.ndarray         # [T, nu]
    solve_stats: list[SolveStats]
    contact_flags: np.ndarray  # [T, 2]


def run_dummy_sim(
    runtime: MpcRuntime,
    x0: np.ndarray,
    duration: float,
    mrt_frequency: float,
    mpc_frequency: float,
    command_fn=None,            # t -> raw command (vx, vy, height, wz) in [-1,1]
    flow=None,                  # model flow map; None -> replay policy states
) -> DummySimLog:
    dt_mrt = 1.0 / mrt_frequency
    solve_every = max(int(round(mrt_frequency / mpc_frequency)), 1)

    step_fn = None
    if flow is not None:
        def step_fn(t, x, u):
            def tensor(a):
                return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=runtime.dtype,
                                       device=runtime.device)

            with torch.no_grad():
                out = rk4_step(flow, t, tensor(x), tensor(u), dt_mrt)
            return out.double().cpu().numpy()

    x = np.asarray(x0, dtype=float).copy()
    t = 0.0
    times, states, inputs, flags = [], [], [], []
    stats: list[SolveStats] = []

    n_steps = int(round(duration * mrt_frequency))
    for step in range(n_steps):
        cmd = np.zeros(4) if command_fn is None else np.asarray(command_fn(t), dtype=float)
        if step % solve_every == 0:
            stats.append(runtime.advance(t, x, cmd))

        # ZOH input over [t, t+dt] is the policy input AT t; the replayed or
        # logged state is at t+dt
        _, u, c = runtime.policy.evaluate(t)
        x_pol, _, _ = runtime.policy.evaluate(t + dt_mrt)
        if step_fn is not None:
            # TimeTriggeredRollout: integrate the model dynamics under the
            # policy input from the CURRENT plant state
            x_next = step_fn(t, x, u)
        else:
            x_next = np.asarray(x_pol)
        times.append(t)
        states.append(x.copy())
        inputs.append(np.asarray(u).copy())
        flags.append(np.asarray(c).copy())
        x = x_next.astype(float).copy()
        t += dt_mrt

    return DummySimLog(
        times=np.asarray(times),
        states=np.asarray(states),
        inputs=np.asarray(inputs),
        solve_stats=stats,
        contact_flags=np.asarray(flags),
    )
