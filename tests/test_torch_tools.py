"""The port's host tools, its launch CLI and the helpers that the last slice
ported, against the JAX package's on the CPU.

- `tools/observation_logger.py`, `tools/commands.py`, `tools/benchmarks.py`:
  the same inputs through both packages give the same arrays, CSV bytes,
  commands, requests, summaries and rates (exactly).
- `tools/launch.py`: `dummy-sim` on toy_biped (centroidal, N = 8, 0.2 s at
  50 / 25 Hz, float64 on the CPU) through the port's `main` and through the
  JAX package's on the same files: the two `--log-csv` files have the same
  header and rows within LOOP_TOL x max(1, max|ref|); `mujoco-sim` (0.2 s,
  500 / 25 Hz) runs with no reset and the base above 0.75 x 0.78321 m.
  `DEFAULT_PATHS` equals JAX's key for key, and `--urdf` set to the G1's
  path selects the G1's task, reference, gait and MJCF (path strings only:
  the G1's files are not in the repository).
- The helpers: `rot_to_quat`, `rotation_error_world`, `rpy_to_rot`,
  `kinetic_energy`, `potential_energy`, the layouts' `with_*` setters,
  `WholeBodyModel.initial_state` and `node_cost`, at 1e-12 (float64).
"""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import ASSETS, NO_BATCHING_FALLBACK, jax_wb, port_wb
from wb_humanoid_mpc_tpu.models import dynamics as jax_dyn
from wb_humanoid_mpc_tpu.models import layout as jax_layout
from wb_humanoid_mpc_tpu.ocp import base as jax_base
from wb_humanoid_mpc_tpu.tools import benchmarks as jax_bench
from wb_humanoid_mpc_tpu.tools import commands as jax_commands
from wb_humanoid_mpc_tpu.tools import launch as jax_launch
from wb_humanoid_mpc_tpu.tools import observation_logger as jax_obs
from wb_humanoid_mpc_tpu.utils import rotations as jax_rot
from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.models import dynamics, layout
from wb_humanoid_mpc_tpu_torch.ocp import base
from wb_humanoid_mpc_tpu_torch.tools import benchmarks, commands, launch, observation_logger
from wb_humanoid_mpc_tpu_torch.utils import rotations

pytestmark = pytest.mark.filterwarnings(NO_BATCHING_FALLBACK)

TOL = 1e-12        # the helpers, float64
LOOP_TOL = 1e-8    # x max(1, max|ref|): the CLI's dummy-sim CSV, as the dummy-sim tests


# ---- host tools ----

def test_observation_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    logs = (observation_logger.ObservationLogger(), jax_obs.ObservationLogger())
    for i in range(6):
        x, u = rng.normal(size=5), rng.normal(size=3)
        for log in logs:
            log.log(0.01 * i, x, u, mode=i % 4)
    for a, b in zip(logs[0].to_arrays(), logs[1].to_arrays()):
        np.testing.assert_array_equal(a, b)
    paths = [tmp_path / "port.csv", tmp_path / "jax.csv"]
    for log, p in zip(logs, paths):
        log.dump_csv(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    h0, d0 = observation_logger.ObservationLogger.load_csv(str(paths[0]))
    h1, d1 = jax_obs.ObservationLogger.load_csv(str(paths[1]))
    assert h0 == h1 and h0[:3] == ["time", "mode", "state_0"]
    np.testing.assert_array_equal(d0, d1)


class _Manager:
    def __init__(self):
        self.calls = []

    def request_gait(self, name):
        if name == "nope":
            raise KeyError(name)
        self.calls.append(("gait", name))

    def set_pose_command(self, p):
        self.calls.append(("pose", tuple(np.asarray(p).tolist())))


def test_command_bus_and_keyboard_match_jax():
    lines = ["vel 0.5 -0.2 0.1", "height 0.05", "gait trot", "pose 0.1 0 0 15", "",
             "vel 3 -4 2", "gait nope", "stop", "bogus 1 2"]
    buses = (commands.CommandBus(), jax_commands.CommandBus())
    kbs = (commands.KeyboardCommandSource(buses[0], stream=io.StringIO()),
           jax_commands.KeyboardCommandSource(buses[1], stream=io.StringIO()))
    mms = (_Manager(), _Manager())
    for line in lines:
        for kb, bus, mm in zip(kbs, buses, mms):
            kb.handle_line(line)
            bus.drain_into(mm)
        np.testing.assert_array_equal(buses[0].get_velocity(), buses[1].get_velocity())
    assert mms[0].calls == mms[1].calls == [("gait", "trot"), ("pose", (0.1, 0.0, 0.0, 15.0))]
    np.testing.assert_array_equal(buses[0].get_velocity(), [0.0, 0.0, 0.0, 0.0])
    cmd = (5.0, -5.0, 0.2, 2.0)
    np.testing.assert_array_equal(commands.WalkingVelocityCommand(*cmd).to_vector(),
                                  jax_commands.WalkingVelocityCommand(*cmd).to_vector())
    # the joystick source reports a missing pygame instead of raising
    assert commands.XboxCommandSource(buses[0]).start() == \
        jax_commands.XboxCommandSource(buses[1]).start()


def test_benchmarks_publisher_matches_jax():
    @dataclasses.dataclass
    class Stats:
        solve_time: float
        reference_time: float
        cost: float
        g_norm: float
        step_size: float
        riccati_time: float = 0.0

    rng = np.random.default_rng(1)
    pubs = (benchmarks.BenchmarksPublisher(), jax_bench.BenchmarksPublisher())
    seen = ([], [])
    for pub, s in zip(pubs, seen):
        pub.subscribe(s.append)
    for i in range(12):
        st = Stats(*rng.uniform(1e-3, 1e-1, 5), riccati_time=0.001 * i)
        for pub in pubs:
            pub.publish(st)
    assert pubs[0].summary() == pubs[1].summary()
    assert pubs[0].summary()["n_solves"] == 12 and "riccati_time_p50" in pubs[0].summary()
    assert [dataclasses.astuple(b) for b in seen[0]] == [dataclasses.astuple(b)
                                                         for b in seen[1]]
    assert benchmarks.BenchmarksPublisher().summary() == {}


def test_fps_tracker_matches_jax():
    trackers = (benchmarks.FPSTracker(), jax_bench.FPSTracker())
    t = 0.0
    rng = np.random.default_rng(2)
    for _ in range(30):
        t += rng.uniform(0.01, 0.03)
        assert trackers[0].tick(t) == trackers[1].tick(t)
    assert 30.0 < trackers[0].fps < 100.0


# ---- the launch CLI ----

def _toy_args(formulation):
    urdf, task, ref, gait = interface.mpc_files(ASSETS / "toy_biped", formulation)
    return ["--formulation", formulation, "--urdf", urdf, "--task", task, "--reference", ref,
            "--gait", gait, "--n-nodes", "8", "--horizon", "0.32", "--duration", "0.2"]


def test_launch_dummy_sim_matches_jax(tmp_path):
    from wb_humanoid_mpc_tpu.tools import launch as jax_launch

    common = _toy_args("centroidal") + ["--mrt-freq", "50", "--mpc-freq", "25"]
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    out = launch.main(["dummy-sim", *common, "--device", "cpu", "--dtype", "float64",
                       "--log-csv", str(port_csv)])
    jax_launch.main(["dummy-sim", *common, "--log-csv", str(jax_csv)])
    h0, d0 = observation_logger.ObservationLogger.load_csv(str(port_csv))
    h1, d1 = observation_logger.ObservationLogger.load_csv(str(jax_csv))
    assert h0 == h1
    assert d0.shape == d1.shape == (out["ticks"], len(h0)) and out["ticks"] == 10
    err = np.abs(d0 - d1).max()
    assert err <= LOOP_TOL * max(1.0, np.abs(d1).max()), f"CSV off by {err:.3e}"
    assert out["summary"]["n_solves"] == 5 and np.isfinite(out["summary"]["g_norm_max"])


def test_launch_mujoco_sim_on_the_cpu():
    out = launch.main(["mujoco-sim", *_toy_args("wb"), "--device", "cpu", "--dtype",
                       "float64", "--mrt-freq", "500", "--mpc-freq", "25"])
    assert out["resets"] == 0
    assert out["height_range"][0] > 0.75 * 0.78321
    assert out["solves"] == 5
    assert np.isfinite(out["log"].base_positions).all()


def test_launch_defaults_follow_the_urdf():
    args = launch.parse_args(["mujoco-sim"])
    files = launch.robot_files(args)
    assert args.device == "cuda" and args.dtype == "float32"
    assert files["urdf"].endswith("humanoid23/humanoid23.urdf")
    assert files["mjcf"].endswith("humanoid23/humanoid23.xml")
    assert files["task"].endswith("humanoid23/task_centroidal.info")
    assert all(Path(f).is_relative_to(ASSETS) for f in files.values())
    toy = launch.robot_files(launch.parse_args(["dummy-sim", *_toy_args("wb")[:4]]))
    assert toy["mjcf"].endswith("toy_biped/toy_biped.xml")
    assert toy["reference"].endswith("toy_biped/reference_wb.info")


def test_default_paths_match_jax():
    assert list(launch.DEFAULT_PATHS) == list(jax_launch.DEFAULT_PATHS)
    for key, path in jax_launch.DEFAULT_PATHS.items():
        assert launch.DEFAULT_PATHS[key] == path, key


@pytest.mark.parametrize("formulation", ["centroidal", "wb"])
def test_the_g1_urdf_selects_the_g1_files(formulation):
    """`--urdf <g1>` takes every other file from DEFAULT_PATHS, as the JAX
    CLI's defaults do; a flag given still wins."""
    g1 = launch.DEFAULT_PATHS
    argv = ["mujoco-sim", "--formulation", formulation, "--urdf", g1["urdf"]]
    files = launch.robot_files(launch.parse_args(argv))
    assert files == {"urdf": g1["urdf"], "task": g1[f"{formulation}_task"],
                     "reference": g1[f"{formulation}_ref"], "gait": g1["gait"],
                     "mjcf": g1["mjcf"]}
    given = launch.robot_files(launch.parse_args([*argv, "--gait", "my_gait.info"]))
    assert given["gait"] == "my_gait.info" and given["task"] == files["task"]


# ---- the helpers ----

def _rotations(rng, n):
    quat = rng.normal(size=(n, 4))
    R = np.asarray(jax_rot.quat_to_rot(jnp.asarray(quat / np.linalg.norm(quat, axis=1)[:, None])))
    # one rotation in each branch of Shepperd's method: trace > 0, and pi
    # about x, y and z (m00, m11, m22 largest in turn)
    branch = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.diag([-1.0, -1.0, 1.0])]
    return np.concatenate([R, np.stack(branch)])


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(3)
    R = _rotations(rng, 16)
    Rt = torch.as_tensor(R)
    np.testing.assert_allclose(rotations.rot_to_quat(Rt).numpy(),
                               np.asarray(jax_rot.rot_to_quat(jnp.asarray(R))), rtol=0, atol=TOL)
    R_ref = R[rng.permutation(len(R))]
    R_near = R @ np.asarray(jax_rot.rpy_to_rot(jnp.asarray(rng.normal(size=(len(R), 3)) * 1e-4)))
    for B in (R_ref, R_near, R):
        np.testing.assert_allclose(
            rotations.rotation_error_world(Rt, torch.as_tensor(B)).numpy(),
            np.asarray(jax_rot.rotation_error_world(jnp.asarray(R), jnp.asarray(B))),
            rtol=0, atol=TOL)
    rpy = rng.normal(size=(8, 3))
    np.testing.assert_allclose(rotations.rpy_to_rot(torch.as_tensor(rpy)).numpy(),
                               np.asarray(jax_rot.rpy_to_rot(jnp.asarray(rpy))), rtol=0, atol=TOL)


@pytest.mark.parametrize("robot", ["humanoid23", "toy_biped"])
def test_energies_match_jax(robot):
    _, jm, _ = jax_wb(robot)
    _, pm, _ = port_wb(robot)
    rng = np.random.default_rng(4)
    for _ in range(3):
        q = rng.normal(size=pm.robot.nq) * 0.5
        v = rng.normal(size=pm.robot.nq)
        ke = float(dynamics.kinetic_energy(pm.robot, torch.as_tensor(q), torch.as_tensor(v)))
        pe = float(dynamics.potential_energy(pm.robot, torch.as_tensor(q)))
        ke_ref = float(jax_dyn.kinetic_energy(jm.robot, jnp.asarray(q), jnp.asarray(v)))
        pe_ref = float(jax_dyn.potential_energy(jm.robot, jnp.asarray(q)))
        assert abs(ke - ke_ref) <= TOL * max(1.0, abs(ke_ref))
        assert abs(pe - pe_ref) <= TOL * max(1.0, abs(pe_ref))


SETTERS = [("centroidal", "with_momentum", 6), ("centroidal", "with_base_pose", 6),
           ("centroidal", "with_joint_angles", None), ("centroidal", "with_joint_input", None),
           ("centroidal", "with_contact_force", 3), ("wb", "with_base_pose", 6),
           ("wb", "with_joint_angles", None), ("wb", "with_joint_input", None),
           ("wb", "with_contact_force", 3)]


@pytest.mark.parametrize("form,setter,width", SETTERS, ids=[f"{f}-{s}" for f, s, _ in SETTERS])
def test_layout_setters_match_jax(form, setter, width):
    cls = {"centroidal": (layout.CentroidalLayout, jax_layout.CentroidalLayout),
           "wb": (layout.WBLayout, jax_layout.WBLayout)}[form]
    port, ref = cls[0](n_joints=5), cls[1](n_joints=5)
    on_input = setter in ("with_joint_input", "with_contact_force")
    dim = port.input_dim if on_input else port.state_dim
    width = width or 5
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, dim))
    args = (1,) if setter == "with_contact_force" else ()
    for val in (rng.normal(size=(3, width)), rng.normal(size=width), 0.5):
        got = getattr(port, setter)(torch.as_tensor(x), *args, val)
        want = getattr(ref, setter)(jnp.asarray(x), *args, val)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), x)


def test_initial_state_matches_jax():
    _, jm, _ = jax_wb("toy_biped")
    _, pm, _ = port_wb("toy_biped")
    rng = np.random.default_rng(6)
    pose, qj = rng.normal(size=6), rng.normal(size=pm.layout.n_joints)
    got = pm.initial_state(torch.as_tensor(pose), torch.as_tensor(qj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.initial_state(pose, qj)))


def test_node_cost_matches_jax():
    _, _, jocp = jax_wb("toy_biped")
    _, _, pocp = port_wb("toy_biped")
    jbp = jocp.barrier_params()
    pbp = pocp.barrier_params("cpu", torch.float64)
    rng = np.random.default_rng(7)
    n_log, n_quad = pbp.log_mu.shape[-1], pbp.quad_mu.shape[-1]
    arrays = dict(r=rng.normal(size=20), h_log=rng.normal(size=n_log) * 10.0,
                  h_log_mask=(rng.uniform(size=n_log) > 0.3).astype(float),
                  h_quad=rng.normal(size=n_quad), g=rng.normal(size=4))
    got = base.node_cost(base.NodeTerms(**{k: torch.as_tensor(v) for k, v in arrays.items()}),
                         pbp)
    want = jax_base.node_cost(jax_base.NodeTerms(**{k: jnp.asarray(v)
                                                    for k, v in arrays.items()}), jbp)
    assert abs(float(got) - float(want)) <= TOL * max(1.0, abs(float(want)))
