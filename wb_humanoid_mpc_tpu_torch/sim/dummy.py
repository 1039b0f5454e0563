"""Dummy-sim closed loop: integrator plant driven by the MPC policy.

PyTorch counterpart of `wb_humanoid_mpc_tpu/sim/dummy.py` (the headless
equivalent of the reference's `MRT_ROS_Dummy_Loop` + dummy-sim node): at the
MRT rate the plant state advances by rolling out the model dynamics under the
policy input (the reference's `TimeTriggeredRollout` semantics), and at the
MPC rate a new solve is triggered.

The plant state is float64 numpy between steps, as in the JAX package; each
step runs `rk4_step(flow, ...)` on the solver's device, in its dtype
(`PlantStep`): on the card as one replay of a CUDA graph, the counterpart of
the JAX package's `jax.jit` around it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.mpc.runtime import MpcRuntime, SolveStats
from wb_humanoid_mpc_tpu_torch.solver.transcription import rk4_step
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction


@dataclasses.dataclass
class DummySimLog:
    times: np.ndarray          # [T]
    states: np.ndarray         # [T, nx]
    inputs: np.ndarray         # [T, nu]
    solve_stats: list[SolveStats]
    contact_flags: np.ndarray  # [T, 2]


class PlantStep:
    """x(t + dt) = rk4_step(flow, t, x, u, dt) from float64 host values to
    a float64 host array, computed on `device` in `dtype` with t a 0-d
    tensor, as JAX's jitted step traces it. `graphs`: None (the default)
    replays a CUDA graph per (nx, nu) on a CUDA device (`graph`, captured at
    the first step; t lies in a 0-d buffer) and steps eagerly on the CPU;
    True graphs (raises on the CPU); False steps eagerly."""

    def __init__(self, flow, dt: float, device: torch.device, dtype,
                 graphs: bool | None = None):
        self.flow, self.dt, self.device, self.dtype = flow, dt, device, dtype
        if graphs is None:
            graphs = device.type == "cuda"
        self.graph = (GraphedFunction(self.step, device, "the dummy plant's RK4 step")
                      if graphs else None)

    def step(self, t, x, u):
        return rk4_step(self.flow, t, x, u, self.dt)

    def __call__(self, t: float, x, u) -> np.ndarray:
        args = [torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype)
                for a in (t, x, u)]
        with torch.no_grad():
            if self.graph is None:
                out = self.step(*(a.to(self.device) for a in args))
            else:
                out = self.graph.run(*args)
            return out.double().cpu().numpy()


def run_dummy_sim(
    runtime: MpcRuntime,
    x0: np.ndarray,
    duration: float,
    mrt_frequency: float,
    mpc_frequency: float,
    command_fn=None,            # t -> raw command (vx, vy, height, wz) in [-1,1]
    flow=None,                  # model flow map; None -> replay policy states
    graphs: bool | None = None,  # the plant step's (`PlantStep`)
) -> DummySimLog:
    dt_mrt = 1.0 / mrt_frequency
    solve_every = max(int(round(mrt_frequency / mpc_frequency)), 1)

    step_fn = None
    if flow is not None:
        step_fn = PlantStep(flow, dt_mrt, runtime.device, runtime.dtype, graphs)

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
