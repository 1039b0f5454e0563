"""PyTorch port, the host-side reference pipeline against the JAX package:
`refs/gait.py` (mode schedules, template tiling), `refs/swing.py` (the swing
planner), `refs/targets.py` and `refs/manager.py` (`MotionManager.pre_solve`),
all numpy in both packages and fed the committed `assets/gait.info`,
`reference_*.info` and task files of `humanoid23`.

Mode schedules and tilings must be identical; swing references, target
states and `pre_solve` outputs equal to 1e-12 max(1, max|ref|). The seven
checks of tests/test_gait_swing.py run as parametrised cases on the in-repo
gait.info, for each package."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, mpc_files

GAIT_INFO = str(ASSETS / "gait.info")
PACKAGES = ["wb_humanoid_mpc_tpu", "wb_humanoid_mpc_tpu_torch"]


def _mods(package: str):
    """(config, gait, swing, targets, manager) modules of a package."""
    return tuple(importlib.import_module(f"{package}.{m}")
                 for m in ("core.config", "refs.gait", "refs.swing", "refs.targets",
                           "refs.manager"))


# ---- the checks of tests/test_gait_swing.py, on the in-repo gait.info ----

def _check_mode_flag_roundtrip(config, gait, swing):
    for m in range(4):
        assert gait.contact_flags_to_mode(gait.mode_to_contact_flags(m)) == m
    assert gait.mode_to_contact_flags(gait.LF).tolist() == [True, False]
    assert gait.mode_to_contact_flags(gait.RF).tolist() == [False, True]
    assert gait.mode_to_contact_flags(gait.STANCE).tolist() == [True, True]
    assert gait.mode_to_contact_flags(gait.FLY).tolist() == [False, False]


def _check_gait_schedule_tiling(config, gait, swing):
    gaits = config.load_gait_library(GAIT_INFO)
    gs = gait.default_gait_schedule([gait.STANCE, gait.STANCE], [0.5], gaits["stance"])
    gs.insert_mode_sequence_template(gaits["walk"], 1.0, 3.0)
    ms = gs.get_mode_schedule(0.0, 3.0)
    # walk cycle LF, STANCE, RF, STANCE with durations .6/.1/.6/.1 starting at 1.0
    assert ms.mode_at(0.2) == gait.STANCE
    assert ms.mode_at(1.1) == gait.LF
    assert ms.mode_at(1.65) == gait.STANCE
    assert ms.mode_at(1.8) == gait.RF
    assert ms.mode_at(2.35) == gait.STANCE
    assert ms.mode_at(2.5) == gait.LF
    assert np.all(np.diff(ms.event_times) > 0)
    assert len(ms.mode_sequence) == len(ms.event_times) + 1


def _check_gait_schedule_receding_window(config, gait, swing):
    gaits = config.load_gait_library(GAIT_INFO)
    gs = gait.default_gait_schedule([gait.STANCE, gait.STANCE], [0.5], gaits["trot"])
    gs.insert_mode_sequence_template(gaits["trot"], 0.5, 2.0)
    ms1 = gs.get_mode_schedule(0.0, 2.0)
    ms2 = gs.get_mode_schedule(1.0, 3.0)
    for t in np.linspace(1.01, 1.95, 10):
        assert ms1.mode_at(t) == ms2.mode_at(t), t


def _check_cubic_spline_endpoints(config, gait, swing):
    sp = swing.CubicSpline(0.2, 1.0, -0.5, 0.8, 2.0, 0.3)
    np.testing.assert_allclose(sp.position(0.2), 1.0, atol=1e-12)
    np.testing.assert_allclose(sp.position(0.8), 2.0, atol=1e-12)
    np.testing.assert_allclose(sp.velocity(0.2), -0.5, atol=1e-12)
    np.testing.assert_allclose(sp.velocity(0.8), 0.3, atol=1e-12)
    for t in [0.3, 0.5, 0.7]:
        fd = (sp.position(t + 1e-7) - sp.position(t - 1e-7)) / 2e-7
        np.testing.assert_allclose(sp.velocity(t), fd, rtol=1e-5)
        fd2 = (sp.velocity(t + 1e-7) - sp.velocity(t - 1e-7)) / 2e-7
        np.testing.assert_allclose(sp.acceleration(t), fd2, rtol=1e-4)


def _check_spline_cpg_apex(config, gait, swing):
    cpg = swing.SplineCpg(0.0, 0.0, 0.05, 0.08, 0.6, -0.001, 0.0)
    np.testing.assert_allclose(cpg.position(0.3), 0.08, atol=1e-12)
    np.testing.assert_allclose(cpg.velocity(0.3), 0.0, atol=1e-10)
    np.testing.assert_allclose(cpg.position(0.0), 0.0, atol=1e-12)
    np.testing.assert_allclose(cpg.position(0.6), -0.001, atol=1e-12)


def _walk_schedule(config, gait):
    gaits = config.load_gait_library(GAIT_INFO)
    gs = gait.default_gait_schedule([gait.STANCE, gait.STANCE], [0.3], gaits["walk"])
    gs.insert_mode_sequence_template(gaits["walk"], 0.3, 3.0)
    return gs.get_mode_schedule(0.0, 3.0)


def _check_swing_planner_walk(config, gait, swing):
    cfg = config.SwingTrajectoryConfig()
    planner = swing.SwingTrajectoryPlanner(cfg)
    planner.update(_walk_schedule(config, gait), terrain_height=0.0)
    # first LF phase is [0.3, 0.9]: left in contact, right swinging
    assert planner.contact_flag(0, 0.6)
    assert not planner.contact_flag(1, 0.6)
    s = min(1.0, 0.6 / cfg.swing_time_scale)
    np.testing.assert_allclose(planner.z_position(1, 0.6),
                               min(0.0, cfg.touch_down_height_offset) + s * cfg.swing_height,
                               atol=1e-10)
    np.testing.assert_allclose(planner.z_position(1, 0.3 + 1e-9), 0.0, atol=1e-6)
    np.testing.assert_allclose(planner.z_position(1, 0.9 - 1e-9),
                               cfg.touch_down_height_offset, atol=1e-6)
    np.testing.assert_allclose(planner.z_position(0, 0.6), 0.0, atol=1e-12)
    np.testing.assert_allclose(planner.impact_proximity(0, 0.6), 1.0)
    np.testing.assert_allclose(planner.impact_proximity(1, 0.6),
                               cfg.impact_proximity_factor_mid_point_value, atol=1e-10)


def _check_sample_swing_reference_shapes(config, gait, swing):
    planner = swing.SwingTrajectoryPlanner(config.SwingTrajectoryConfig())
    planner.update(_walk_schedule(config, gait), 0.0)
    ref = swing.sample_swing_reference(planner, np.linspace(0.0, 1.2, 61))
    assert ref.contact_flags.shape == (61, 2)
    assert np.isfinite(ref.z_pos).all()
    assert np.isfinite(ref.z_vel).all()
    assert ref.contact_flags[0].tolist() == [1.0, 1.0]


CHECKS = {f.__name__[len("_check_"):]: f for f in (
    _check_mode_flag_roundtrip, _check_gait_schedule_tiling,
    _check_gait_schedule_receding_window, _check_cubic_spline_endpoints,
    _check_spline_cpg_apex, _check_swing_planner_walk, _check_sample_swing_reference_shapes)}


@pytest.mark.parametrize("package", PACKAGES, ids=["jax", "port"])
@pytest.mark.parametrize("check", list(CHECKS))
def test_gait_swing_check(check, package):
    config, gait, swing, _, _ = _mods(package)
    CHECKS[check](config, gait, swing)


# ---- the port against JAX ----

def _schedule_ops(package: str):
    """A fixed sequence of template insertions and receding windows; every
    schedule it reads, as (event_times, mode_sequence)."""
    config, gait, _, _, _ = _mods(package)
    gaits = config.load_gait_library(GAIT_INFO)
    gs = gait.default_gait_schedule([gait.STANCE, gait.STANCE], [0.5], gaits["stance"], 0.4)
    out = []
    t = 0.0
    for name, at in (("walk", 0.6), ("trot", 2.1), ("slow_walk", 3.3), ("run", 4.4),
                     ("stance", 5.5), ("slower_trot", 6.0)):
        while t < at:
            ms = gs.get_mode_schedule(t - 1.2, t + 2.4)
            out.append((ms.event_times.copy(), ms.mode_sequence.copy()))
            t = round(t + 0.13, 10)
        gs.insert_mode_sequence_template(gaits[name], at + 0.05, at + 1.8)
        out.append((gs.get_mode_schedule(at - 0.5, at + 3.0).event_times.copy(),
                    gs.current_template.mode_sequence.copy()))
    return out


def test_gait_tiling_matches_jax():
    ref, got = _schedule_ops(PACKAGES[0]), _schedule_ops(PACKAGES[1])
    assert len(got) == len(ref) > 40
    for (gt, gm), (rt, rm) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gm, rm)


def _manager(package: str, formulation: str, robot: str = "humanoid23"):
    """MotionManager of `package` for `formulation` on the committed files,
    wired as `build_*_mpc` wires it (N = 28 over the horizon)."""
    config, _, _, targets, manager = _mods(package)
    factory = importlib.import_module(f"{package}.models.robot.factory")
    urdf, task, reference, gait_file = mpc_files(ASSETS / robot, formulation)
    probe = config.load_task_config(task, formulation, 1, 1)
    joints = factory.mpc_joint_names(urdf, probe.model_settings.fixed_joint_names)
    n = len(joints)
    nx = 12 + (n if formulation == "centroidal" else 2 * n)
    cfg = config.load_task_config(task, formulation, nx, 12 + n)
    ref_cfg = config.load_reference_config(reference, n)
    horizon = 28 * 0.035
    calc = (targets.CentroidalTargetCalculator if formulation == "centroidal"
            else targets.WBTargetCalculator)(ref_cfg=ref_cfg, mpc_horizon=horizon)
    arms = {role: joints.index(j) for role, j in cfg.model_settings.arm_joint_names.items()
            if j in joints}
    mm = manager.MotionManager(
        ref_cfg=ref_cfg, swing_cfg=cfg.swing, gait_map=config.load_gait_library(gait_file),
        target_calculator=calc, horizon=horizon, n_nodes=28,
        joint_start_index=12 if formulation == "centroidal" else 6, arm_indices=arms,
        phase_transition_stance_time=cfg.model_settings.phase_transition_stance_time)
    return mm, np.asarray(cfg.initial_state), arms


def _drive(package: str, formulation: str):
    """pre_solve over 2 s at 25 Hz: stance, then vx 0.3 (the FSM walks),
    a trot request at 0.8 s, a pose command at 1.4 s; states near the
    initial one from a seed."""
    mm, x0, arms = _manager(package, formulation)
    assert len(arms) == 4
    rng = np.random.default_rng(7)
    out = []
    for k in range(50):
        t = 0.04 * k
        if abs(t - 0.8) < 1e-9:
            mm.request_gait("trot")
        if abs(t - 1.4) < 1e-9:
            mm.set_pose_command(np.array([0.1, 0.0, -0.05, 10.0]))
        cmd = np.array([0.3 if 0.3 <= t < 1.4 else 0.0, 0.0, 0.0, 0.05 if t >= 1.0 else 0.0])
        x = x0 + 0.01 * rng.normal(size=x0.shape)
        base_vel = 0.3 * rng.normal(size=6)
        refs = mm.pre_solve(t, x, cmd, 0.04, base_vel)
        out.append((refs.mode_schedule.event_times, refs.mode_schedule.mode_sequence,
                    refs.gait_name, refs.swing.contact_flags, refs.swing.z_pos,
                    refs.swing.z_vel, refs.swing.z_acc, refs.swing.proximity, refs.x_ref))
    return out


@pytest.mark.parametrize("formulation", ["centroidal", "wb"])
def test_pre_solve_matches_jax(formulation):
    ref, got = _drive(PACKAGES[0], formulation), _drive(PACKAGES[1], formulation)
    gaits = {r[2] for r in ref}
    assert {"stance", "trot"} <= gaits and len(gaits) >= 3, gaits
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g[0], r[0], err_msg=f"tick {k} event times")
        np.testing.assert_array_equal(g[1], r[1], err_msg=f"tick {k} modes")
        assert g[2] == r[2], k
        for i, name in enumerate(("contact", "z_pos", "z_vel", "z_acc", "proximity", "x_ref"),
                                 start=3):
            a, b = np.asarray(g[i], np.float64), np.asarray(r[i], np.float64)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()),
                                       err_msg=f"tick {k} {name}")
    # the trot and the walk put single-support nodes into the horizon
    assert any((r[3].sum(axis=1) < 2).any() for r in ref)


@pytest.mark.parametrize("formulation", ["centroidal", "wb"])
def test_targets_match_jax(formulation):
    """velocity_to_targets, position_to_targets (pose command), apply_arm_swing
    and gait_phase_variable on seeded inputs."""
    outs = []
    for package in PACKAGES:
        _, gait, _, targets, _ = _mods(package)
        mm, x0, arms = _manager(package, formulation)
        calc = mm.calc
        r = np.random.default_rng(11)
        res = []
        for k in range(5):
            x = x0 + 0.05 * r.normal(size=x0.shape)
            cmd = calc.scale_command(r.uniform(-1, 1, size=4))
            tt = calc.velocity_to_targets(cmd, 0.1 * k, x)
            res += [tt.times, tt.states, tt.sample(np.linspace(0.1 * k - 0.1, 0.1 * k + 1.2, 13))]
            js = mm.joint_start
            pt = calc.position_to_targets(r.uniform(-1, 1, size=4), 0.1 * k, x,
                                          slice(js - 6, js), len(x))
            res += [pt.times, pt.states]
        ms = mm.gait_schedule.get_mode_schedule(0.0, 3.0)
        times = np.linspace(0.0, 3.0, 40)
        phase = targets.gait_phase_variable(gait.ModeSchedule(np.array([0.5, 1.1, 1.2, 1.8]),
                                                              np.array([3, 2, 3, 1, 3])), times)
        res += [phase, ms.event_times,
                targets.apply_arm_swing(np.tile(x0, (40, 1)), phase, 0.3, mm.joint_start, arms)]
        outs.append(res)
    ref, got = outs
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
                                   atol=1e-12 * max(1.0, float(np.abs(b).max())), err_msg=str(i))
