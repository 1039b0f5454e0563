"""CLI launch entry points: the `make launch-*` / ros2-launch analogues.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/tools/launch.py`
(reference `mpc_launch_config.py:27-120`, `dummy_sim.launch.py`):

    python -m wb_humanoid_mpc_tpu_torch.tools.launch dummy-sim  --formulation centroidal
    python -m wb_humanoid_mpc_tpu_torch.tools.launch mujoco-sim --formulation wb
    python -m wb_humanoid_mpc_tpu_torch.tools.launch bench-batched --batch 256

The MPC solves on `--device` (default `cuda`: the card, through the port's
kernels; `--device cpu` runs the plain versions on the CPU) in `--dtype`.
The robot files default to the port's `assets/humanoid23`: the task,
reference and gait files follow `--urdf`'s directory (`interface.mpc_files`)
and the MJCF is `<urdf dir>/<name>.xml`, so `--urdf .../toy_biped.urdf`
selects that robot whole. `--urdf` set to `DEFAULT_PATHS["urdf"]`, the G1
of the reference tree under `WBMPC_REFERENCE_ROOT` (JAX's default robot),
selects the G1 whole from `DEFAULT_PATHS`. Velocity commands come from
`--vx/--vy/--wz` or, with `--interactive`, from stdin (`vel 0.3 0 0`,
`gait trot`, `stop`).
`main(argv)` returns the numbers it prints, in a dict.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, mpc_files

_REF = os.environ.get("WBMPC_REFERENCE_ROOT", "/root/reference")
_G1 = os.path.join(_REF, "robot_models/unitree_g1")
DEFAULT_PATHS = {   # the G1 files of the reference tree, as the JAX CLI has them
    "urdf": os.path.join(_G1, "g1_description/urdf/g1_29dof.urdf"),
    "mjcf": os.path.join(_G1, "g1_description/urdf/g1_29dof.xml"),
    "gait": os.path.join(_REF, "humanoid_nmpc/humanoid_common_mpc/config/command/gait.info"),
    "centroidal_task": os.path.join(_G1, "g1_centroidal_mpc/config/mpc/task.info"),
    "centroidal_ref": os.path.join(_G1, "g1_centroidal_mpc/config/command/reference.info"),
    "wb_task": os.path.join(_G1, "g1_wb_mpc/config/mpc/task.info"),
    "wb_ref": os.path.join(_G1, "g1_wb_mpc/config/command/reference.info"),
}
DEFAULT_URDF = str(ASSETS / "humanoid23" / "humanoid23.urdf")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def robot_files(args) -> dict:
    """The urdf, task, reference, gait and MJCF paths of `args`: each given
    flag as given, the rest from `DEFAULT_PATHS` when `--urdf` is the G1's,
    else from `--urdf`'s asset directory."""
    urdf = Path(args.urdf)
    if str(urdf) == DEFAULT_PATHS["urdf"]:
        task = DEFAULT_PATHS[f"{args.formulation}_task"]
        ref = DEFAULT_PATHS[f"{args.formulation}_ref"]
        gait, mjcf = DEFAULT_PATHS["gait"], DEFAULT_PATHS["mjcf"]
    else:
        _, task, ref, gait = mpc_files(urdf.parent, args.formulation)
        mjcf = str(urdf.with_suffix(".xml"))
    return {"urdf": str(urdf), "task": args.task or task, "reference": args.reference or ref,
            "gait": args.gait or gait, "mjcf": args.mjcf or mjcf}


def _build(args):
    from wb_humanoid_mpc_tpu_torch.interface import build_centroidal_mpc, build_wb_mpc

    f = robot_files(args)
    build = build_centroidal_mpc if args.formulation == "centroidal" else build_wb_mpc
    return build(f["urdf"], f["task"], f["reference"], f["gait"], n_nodes=args.n_nodes,
                 horizon=args.horizon, sqp_iterations=args.sqp_iterations,
                 device=args.device, dtype=DTYPES[args.dtype])


def _controller(args, mpc):
    from wb_humanoid_mpc_tpu_torch.mpc.controller import CentroidalMrtController, WBMrtController

    cls = CentroidalMrtController if args.formulation == "centroidal" else WBMrtController
    return cls(mpc.model, device=args.device, dtype=DTYPES[args.dtype])


def cmd_dummy_sim(args) -> dict:
    """Kinematic closed loop (`make launch-g1-dummy-sim`)."""
    from wb_humanoid_mpc_tpu_torch.sim.dummy import run_dummy_sim
    from wb_humanoid_mpc_tpu_torch.tools.benchmarks import BenchmarksPublisher
    from wb_humanoid_mpc_tpu_torch.tools.observation_logger import ObservationLogger
    from wb_humanoid_mpc_tpu_torch.viz.visualizer import TrajectoryVisualizer

    mpc = _build(args)
    cmd = np.array([args.vx, args.vy, args.height, args.wz])
    print(f"[dummy-sim] {args.formulation} MPC, N={mpc.n_nodes}, dt={mpc.dt}, "
          f"{mpc.runtime.device} {args.dtype}; command={cmd}")
    if args.interactive or args.gui:
        # operator plane: stdin commands `vel vx vy wz`, `gait trot`,
        # `pose dx dy dz dyaw`, `height h`, `stop` (reference keyboard
        # publishers + pose command node), optionally the Tk velocity GUI
        from wb_humanoid_mpc_tpu_torch.tools.commands import CommandBus, KeyboardCommandSource

        bus = CommandBus()
        KeyboardCommandSource(bus).start()
        if args.gui:
            from wb_humanoid_mpc_tpu_torch.tools.velocity_gui import launch_velocity_gui

            launch_velocity_gui(bus)

        def command_fn(t):
            bus.drain_into(mpc.motion_manager)
            return bus.get_velocity()
    else:
        def command_fn(t):
            return cmd if t > 0.2 else np.zeros(4)
    log = run_dummy_sim(
        mpc.runtime, mpc.initial_state, duration=args.duration,
        mrt_frequency=args.mrt_freq, mpc_frequency=args.mpc_freq,
        command_fn=command_fn, flow=mpc.model.flow_map)

    pub = BenchmarksPublisher()
    for s in log.solve_stats:
        pub.publish(s)
    summary = pub.summary()
    xy = mpc.model.layout.base_position(log.states[-1])[:2]
    print("[dummy-sim] solve summary:", json.dumps(summary, indent=2))
    print(f"[dummy-sim] final base xy: {xy[0]:.3f}, {xy[1]:.3f}")
    out = {"summary": summary, "final_base_xy": [float(xy[0]), float(xy[1])],
           "ticks": len(log.times), "log": log}

    if args.log_csv:
        ol = ObservationLogger()
        for i in range(len(log.times)):
            ol.log(log.times[i], log.states[i], log.inputs[i])
        ol.dump_csv(args.log_csv)
        print(f"[dummy-sim] observations -> {args.log_csv}")
    if args.plot:
        TrajectoryVisualizer.export_summary(
            log, args.plot, state_z_index=8 if args.formulation == "centroidal" else 2)
        print(f"[dummy-sim] summary plot -> {args.plot}")
    if args.scene:
        from wb_humanoid_mpc_tpu_torch.viz.visualizer import render_scene

        render_scene(mpc.model, log.states[-1], policy=mpc.runtime.policy, x_target=None,
                     u_current=log.inputs[-1], out_path=args.scene)
        print(f"[dummy-sim] final scene (current/terminal robots, CoP, "
              f"corner forces) -> {args.scene}")
    return out


def cmd_mujoco_sim(args) -> dict:
    """Full-physics closed loop (`make launch-g1-sim`)."""
    from wb_humanoid_mpc_tpu_torch.sim.closed_loop import run_mujoco_closed_loop
    from wb_humanoid_mpc_tpu_torch.sim.mujoco_sim import MujocoSimInterface

    mpc = _build(args)
    lay = mpc.model.layout
    x0 = mpc.initial_state
    joint_defaults = {name: float(v) for name, v in
                      zip(mpc.model.robot.joint_names, lay.joint_angles(x0))}
    sim = MujocoSimInterface(robot_files(args)["mjcf"], initial_joint_positions=joint_defaults,
                             initial_base_pos=(0.0, 0.0, float(lay.base_position(x0)[2])))
    controller = _controller(args, mpc)
    ages = _record_policy_ages(controller)
    cmd = np.array([args.vx, args.vy, args.height, args.wz])

    def command_fn(t):
        return cmd if t > 0.5 else np.zeros(4)

    out = {}
    if args.threaded:
        from wb_humanoid_mpc_tpu_torch.sim.sim_thread import run_threaded_robot_sim

        log, metrics, renderer = run_threaded_robot_sim(
            mpc, controller, sim, duration=args.duration,
            mrt_frequency=args.mrt_freq, command_fn=command_fn,
            realtime=args.realtime, render_fps=args.render_fps)
        frames = len(renderer.frames) if renderer else 0
        print(f"[mujoco-sim threaded] sim fps={metrics.sim_fps:.0f}, "
              f"rt factor={metrics.realtime_factor:.2f}, frames={frames}")
        out.update(sim_fps=metrics.sim_fps, realtime_factor=metrics.realtime_factor,
                   frames=frames)
    else:
        log = run_mujoco_closed_loop(
            mpc, controller, sim, duration=args.duration,
            mrt_frequency=args.mrt_freq, mpc_frequency=args.mpc_freq,
            command_fn=command_fn, solve_latency=args.solve_latency,
            use_pipeline=args.pipeline)
    lo, hi = float(log.base_heights.min()), float(log.base_heights.max())
    print(f"[mujoco-sim] resets={log.n_resets}, final base: {log.base_positions[-1]}, "
          f"height range [{lo:.3f}, {hi:.3f}]")
    age_ms = np.array(ages) * 1e3
    if age_ms.size:
        print(f"[mujoco-sim] policy age (sim time): p50 {np.percentile(age_ms, 50):.1f} ms, "
              f"max {age_ms.max():.1f} ms over {age_ms.size} ticks with a policy")
    out.update(resets=log.n_resets, final_base=log.base_positions[-1].tolist(),
               height_range=[lo, hi], solves=len(log.solve_stats),
               policy_age_ms=[float(np.percentile(age_ms, 50)), float(age_ms.max())]
               if age_ms.size else None, log=log)
    return out


def _record_policy_ages(controller) -> list:
    """Wrap `controller.compute` to record, each tick that has a policy, its
    age: the tick's sim time minus the policy's t0."""
    ages = []
    compute = controller.compute

    def compute_and_record(t, x, policy):
        if policy is not None:
            ages.append(t - policy.t0)
        return compute(t, x, policy)

    controller.compute = compute_and_record
    return ages


def cmd_bench_batched(args) -> dict:
    """Batched-instance throughput benchmark (BASELINE configs 4/5): the
    whole-body stance problem of `bench.py`, whatever `--formulation` says,
    as in the JAX CLI."""
    from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_throughput

    result = batched_throughput(args.batch, n_nodes=args.n_nodes or 28,
                                formulation=args.formulation, n_rounds=args.rounds,
                                device=args.device, dtype=DTYPES[args.dtype])
    print(json.dumps(result, indent=2))
    return result


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="wb_humanoid_mpc_tpu_torch.tools.launch")
    p.add_argument("command", choices=["dummy-sim", "mujoco-sim", "bench-batched"])
    p.add_argument("--formulation", choices=["centroidal", "wb"], default="centroidal")
    p.add_argument("--device", default="cuda",
                   help="where the MPC solves: cuda (the card, default) or cpu")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--urdf", default=DEFAULT_URDF)
    p.add_argument("--mjcf", default=None, help="default: the URDF's path with .xml")
    p.add_argument("--task", default=None)
    p.add_argument("--reference", default=None)
    p.add_argument("--gait", default=None)
    p.add_argument("--n-nodes", type=int, default=None)
    p.add_argument("--horizon", type=float, default=None)
    p.add_argument("--sqp-iterations", type=int, default=None)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--mrt-freq", type=float, default=100.0)
    p.add_argument("--mpc-freq", type=float, default=50.0)
    p.add_argument("--vx", type=float, default=0.0)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--height", type=float, default=0.0)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--log-csv", default=None)
    p.add_argument("--plot", default=None)
    p.add_argument("--scene", default=None,
                   help="write the final 3-D scene (current/terminal robots, "
                        "optimized base path, CoP, corner forces) to this PNG")
    p.add_argument("--interactive", action="store_true",
                   help="read vel/gait/pose commands from stdin while running")
    p.add_argument("--gui", action="store_true",
                   help="Tk velocity-controller GUI (reference "
                        "base_velocity_controller_gui); headless-safe no-op")
    p.add_argument("--solve-latency", type=float, default=0.0,
                   help="async MRT: policies activate this many sim-seconds "
                        "after their observation (mujoco-sim only)")
    p.add_argument("--threaded", action="store_true",
                   help="three-thread robot sim: dedicated 2 kHz physics "
                        "thread + solver thread + control loop (reference "
                        "MujocoSimInterface.cpp:393+ architecture; "
                        "mujoco-sim only)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the threaded sim to the wall clock")
    p.add_argument("--render-fps", type=float, default=0.0,
                   help="> 0: start the render thread at this fps "
                        "(offscreen frames when GL is available)")
    p.add_argument("--pipeline", action="store_true",
                   help="run the MPC on a real solver thread (MrtPipeline; "
                        "the reference's solverWorker/control split, "
                        "mujoco-sim only)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return {"dummy-sim": cmd_dummy_sim,
            "mujoco-sim": cmd_mujoco_sim,
            "bench-batched": cmd_bench_batched}[args.command](args)


if __name__ == "__main__":
    main()
