"""Driver of the closed MPC loop: one client, the robot's MPC thread,
calling the port's `MpcRuntime.advance` back to back.

A traffic file that names this driver gives the episodes (stance, a walk
command, stance), the gaits they alternate with each gait's raw command,
the observation noise, the warm-up, and how many solves the traced run
traces and the check compares. The seed draws the noise (and the solves
the check samples): every seed gets the same episodes. Simulated time advances by
1 / `mpc_hz` of the configuration a solve; the observed state is the
previous policy's state at the new time plus seeded Gaussian noise, so no
plant runs and the window's time is the MPC's own.

`Program` builds the system under test once (set-up); `Loop` drives it
from a seed; `run` is what `run.py` calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mpcbench import compare
from mpcbench.harness import DeviceTrace

K1_MODULE = "wb_humanoid_mpc_tpu_torch.ops.riccati"
K2_MODULE = "wb_humanoid_mpc_tpu_torch.ops.fkvel"
KERNEL_NAMES = ("riccati_rollout_kernel", "fkvel_kernel")   # K1's, K2's, as traced
TRACE_WINDOW = "mpcbench.traced_window"


@dataclasses.dataclass
class Solve:
    """One request of the window: what the traffic handed the program, and
    what the program answered."""
    episode: int
    step: int                 # solve index within the episode
    t: float                  # simulated time of the observation
    x_obs: np.ndarray
    cmd: np.ndarray
    gait_request: str | None  # requested just before this solve
    wall_s: float             # call to return, the policy on the host
    solve_s: float            # SolveStats.solve_time
    refs_s: float             # SolveStats.reference_time
    iterations: int
    recovery: bool
    g_norm: float
    step_size: float
    xs: np.ndarray
    us: np.ndarray
    contact_flags: np.ndarray


class Program:
    """The port's MPC for one configuration, built and warmed up."""

    def __init__(self, cell, device="cuda", dtype=None, t_start=None):
        t0 = time.perf_counter()
        from wb_humanoid_mpc_tpu_torch import interface
        from wb_humanoid_mpc_tpu_torch.ops import _lib

        self.lib = _lib
        c = cell.config
        self.config = c
        self.device = torch.device(device)
        self.dtype = dtype or getattr(torch, c["dtype"])
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            _lib.library()   # the kernels, built into the checkout at the first run
        t2 = time.perf_counter()
        build = {"wb": interface.build_wb_mpc,
                 "centroidal": interface.build_centroidal_mpc}[c["formulation"]]
        self.mpc = build(str(cell.path(c["urdf"])), str(cell.path(c["task"])),
                         str(cell.path(c["reference"])), str(cell.path(c["gait"])),
                         device=self.device, dtype=self.dtype)
        layout = self.mpc.model.layout
        built = {"n_nodes": self.mpc.n_nodes, "nx": layout.state_dim, "nu": layout.input_dim,
                 "n_eq": self.mpc.ocp.n_eq}
        for key, value in built.items():
            if value != c[key]:
                raise ValueError(f"the program built {key} = {value}; the configuration "
                                 f"states {c[key]}")
        if abs(self.mpc.dt - c["dt"]) > 1e-12:
            raise ValueError(f"the program built dt = {self.mpc.dt}; the configuration "
                             f"states {c['dt']}")
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32 != c["tf32"]:
            raise ValueError("TF32 matrix products are not as the configuration states")
        t3 = time.perf_counter()
        self.setup = {"import_s": t1 - t0, "library_s": t2 - t1, "build_s": t3 - t2}
        self.t_start = t_start

    @property
    def runtime(self):
        return self.mpc.runtime

    def launches(self) -> dict:
        return {name: getattr(self.lib.COUNTERS.get(name), "LAUNCHES", 0)
                for name in (K1_MODULE, K2_MODULE)}

    def release(self) -> None:
        """Free the program's state and its graphs."""
        solve = self.mpc.runtime.solve_fn
        if hasattr(solve, "release"):
            solve.release()
        self.mpc = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Loop:
    """The closed loop over episodes, from a seed."""

    def __init__(self, program: Program, traffic: dict, seed: int):
        self.p = program
        self.tr = traffic
        self.hz = float(program.config["mpc_hz"])
        ep = traffic["episode"]
        self.n_stance = round(ep["stance_s"] * self.hz)
        self.n_walk = round(ep["walk_s"] * self.hz)
        self.n_total = self.n_stance + self.n_walk + round(ep["stance_end_s"] * self.hz)
        self.noise_rng = np.random.default_rng([seed % 2 ** 63, 1])
        self.episode, self.k = -1, self.n_total
        self.hard_resets = 0
        self.x = None
        self.cmd_walk = None
        self.gait = None

    def _noise(self, n: int) -> np.ndarray:
        return self.tr["obs_noise_std"] * self.noise_rng.standard_normal(n)

    def step(self) -> Solve:
        """One solve: the next observation, command and gait request, then
        `advance`."""
        rt = self.p.runtime
        mm = self.p.mpc.motion_manager
        if self.k >= self.n_total:
            self.hard_resets += rt.n_warm_resets
            rt.reset()
            self.episode += 1
            self.k = 0
            gaits = self.tr["gaits"]
            self.gait = gaits[self.episode % len(gaits)]
            self.cmd_walk = np.asarray(self.tr["commands"][self.gait], dtype=np.float64)
            x0 = np.asarray(self.p.mpc.initial_state, dtype=np.float64)
            self.x = x0 + self._noise(x0.shape[0])
        k = self.k
        t = k / self.hz
        request = None
        if k == self.n_stance:
            request = self.gait
        elif k == self.n_stance + self.n_walk:
            request = "stance"
        if request is not None:
            mm.request_gait(request)
        cmd = self.cmd_walk if self.n_stance <= k < self.n_stance + self.n_walk else np.zeros(4)
        x_obs = self.x
        t0 = time.perf_counter()
        stats = rt.advance(t, x_obs, cmd)
        wall = time.perf_counter() - t0
        pol = rt.policy
        rec = Solve(episode=self.episode, step=k, t=t, x_obs=x_obs, cmd=cmd,
                    gait_request=request, wall_s=wall, solve_s=stats.solve_time,
                    refs_s=stats.reference_time, iterations=stats.iterations,
                    recovery=stats.recovery, g_norm=stats.g_norm, step_size=stats.step_size,
                    xs=pol.xs, us=pol.us, contact_flags=pol.contact_flags)
        x_next = np.asarray(pol.evaluate(t + 1.0 / self.hz)[0], dtype=np.float64)
        self.x = x_next + self._noise(x_next.shape[0])
        self.k += 1
        return rec


def warm_up(program: Program, traffic: dict) -> None:
    """The first solves of an episode, before the window: the first call
    captures the solve's graphs (the recovery solve replays the same ones)."""
    w = traffic["warmup"]
    rt, mm = program.runtime, program.mpc.motion_manager
    rt.reset()
    x = np.asarray(program.mpc.initial_state, dtype=np.float64)
    hz = float(program.config["mpc_hz"])
    cmd = np.asarray(w["command"], dtype=np.float64)
    for k in range(w["stance_solves"] + w["walk_solves"]):
        if k == w["stance_solves"]:
            mm.request_gait(w["gait"])
        rt.advance(k / hz, x, cmd if k >= w["stance_solves"] else np.zeros(4))
        x = np.asarray(rt.policy.evaluate((k + 1) / hz)[0], dtype=np.float64)
    rt.reset()


class ReplayTimer:
    """CUDA events around every `torch.cuda.CUDAGraph.replay` inside the
    `with`, on the stream each replay runs on: the device time of the
    program's graphs, which the profiler's kernel tracing would slow."""

    def __init__(self):
        self.pairs: list = []
        self._orig = None

    def __enter__(self):
        cls = torch.cuda.CUDAGraph
        self._orig = orig = cls.replay
        pairs = self.pairs

        def replay(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            orig(graph)
            end.record()
            pairs.append((start, end))

        cls.replay = replay
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.CUDAGraph.replay = self._orig

    def busy_s(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) * 1e-3


@dataclasses.dataclass
class Run:
    """What a run measured: the metrics' readers take their numbers from it."""
    config: dict
    solves: list
    window_s: float
    setup_s: float
    setup: dict
    launches: dict
    hard_resets: int
    memory_peak_bytes: int
    trace: DeviceTrace | None = None       # the traced stretch after the window
    traced_solves: int = 0
    traced_iterations: int = 0
    traced_wall_s: float = 0.0
    traced_launches: dict = dataclasses.field(default_factory=dict)
    replay_busy_s: float | None = None     # graph replays' device time in the window
    replays: int = 0
    checked: list = dataclasses.field(default_factory=list)   # per sampled solve

    def notes(self) -> dict:
        """The run's earlier lines: counts a reader of the result may want."""
        iterations = sum(s.iterations for s in self.solves)
        out = {
            "setup_parts_s": {**self.setup, "setup_s": self.setup_s},
            "launches_per_sqp_iteration": {
                name.rsplit(".", 1)[-1]: (n / iterations if iterations else None)
                for name, n in self.launches.items()},
            "window": {"solves": len(self.solves), "seconds": self.window_s,
                       "iterations": iterations,
                       "recovery_solves": sum(bool(s.recovery) for s in self.solves),
                       "hard_resets": self.hard_resets,
                       "episodes": len({s.episode for s in self.solves}),
                       "solve_ms_p50_p90_p95_p99": [
                           float(np.percentile([s.wall_s for s in self.solves], q)) * 1e3
                           for q in (50, 90, 95, 99)] if self.solves else None},
            "memory_peak_bytes": self.memory_peak_bytes,
            "checked_solves": self.checked,
        }
        if self.trace is not None:
            # kernel records in the trace against the launches the program
            # counted over the traced solves (graph replays included)
            out["traced"] = {"solves": self.traced_solves, "iterations": self.traced_iterations,
                             "wall_s": self.traced_wall_s, "busy_s": self.trace.busy_s,
                             "window_s": self.trace.window_s}
            out["window_graph_replays"] = {"replays": self.replays,
                                           "device_s": self.replay_busy_s}
            out["trace_kernels_vs_counted"] = {
                name.rsplit(".", 1)[-1]: [len(self.trace.kernels(kernel)), n]
                for (name, n), kernel in zip(self.traced_launches.items(), KERNEL_NAMES)}
        return out


def window(program: Program, traffic: dict, seed: int, seconds: float,
           trace: bool = False, beside=None, n_solves: int | None = None) -> tuple[Run, Loop]:
    """The measured window: solves back to back until `seconds` have
    passed (the solve that crosses the deadline ends it), or `n_solves`
    solves when given, inside the context manager `beside` if one is given;
    then, when `trace`, `trace_solves` more solves under `torch.profiler`."""
    loop = Loop(program, traffic, seed)
    cuda = program.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    before = program.launches()
    solves = []
    timer = ReplayTimer() if trace else contextlib.nullcontext()
    with beside or contextlib.nullcontext(), timer:
        t0 = time.perf_counter()
        setup_s = None if program.t_start is None else t0 - program.t_start
        deadline = t0 + seconds
        while True:
            solves.append(loop.step())
            now = time.perf_counter()
            if (now >= deadline) if n_solves is None else (len(solves) >= n_solves):
                break
    window_s = now - t0
    after = program.launches()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    hard = loop.hard_resets + program.runtime.n_warm_resets
    run = Run(config=program.config, solves=solves, window_s=window_s, setup_s=setup_s,
              setup=dict(program.setup), launches={k: after[k] - before[k] for k in after},
              hard_resets=hard, memory_peak_bytes=int(peak))
    if trace:
        run.replay_busy_s, run.replays = timer.busy_s(), len(timer.pairs)
        before = program.launches()
        t1 = time.perf_counter()
        run.trace, stretch = traced(loop, traffic["trace_solves"])
        run.traced_wall_s = time.perf_counter() - t1
        run.traced_solves = len(stretch)
        run.traced_iterations = sum(s.iterations for s in stretch)
        after = program.launches()
        run.traced_launches = {k: after[k] - before[k] for k in after}
    return run, loop


def traced(loop: Loop, n: int) -> tuple[DeviceTrace, list]:
    """`n` more solves of the loop under `torch.profiler`, reduced to their
    device operations: (trace, the solves)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(TRACE_WINDOW):
                stretch = [loop.step() for _ in range(n)]
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        del prof
        return DeviceTrace(path, TRACE_WINDOW), stretch


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        dtype=None, sabotage=None, beside=None) -> tuple[Run, dict]:
    """Set up, warm up, measure, then check the window's policies against
    the reference: (Run, {number compared: (value, limit)}).
    `sabotage(program)` breaks the program before the window (the tests'
    faults)."""
    program = Program(cell, device=device, dtype=dtype, t_start=t_start)
    t0 = time.perf_counter()
    warm_up(program, cell.traffic)
    if program.device.type == "cuda":
        torch.cuda.synchronize()
    program.setup["warmup_s"] = time.perf_counter() - t0
    if sabotage is not None:
        sabotage(program)
    result, _ = window(program, cell.traffic, seed, seconds, trace, beside)
    device = program.device
    program.release()
    sample = compare.choose_sample(result.solves, cell.traffic["check_solves"], seed)
    values, outs, twins = compare.check(cell, result.solves, sample, device)
    for i, o in sorted(outs.items()):
        s = result.solves[i]
        ans = compare.program_answer(s)
        gap, k, same = compare.judge(ans, o.leaves, compare.BRANCH_TOL)
        result.checked.append({"episode": s.episode, "step": s.step, "iterations": s.iterations,
                               "recovery": bool(s.recovery), "gap": gap,
                               "nominal_gap": compare.answer_gap(ans, o.leaves[0]),
                               "branches": len(o.leaves), "branch": k, "same_decisions": same,
                               "twin_gap": twins.get(i)})
    return result, {k: (v, compare.LIMITS[k]) for k, v in values.items()}


def failed(solve: Solve) -> bool:
    """A request whose policy is not finite (`correct` counts them too)."""
    return not (np.isfinite(solve.xs).all() and np.isfinite(solve.us).all())
