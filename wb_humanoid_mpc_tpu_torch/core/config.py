"""Config dataclasses mirroring the reference task/reference/gait info files.

Sections map 1:1 to the reference's flag system (SURVEY.md §5.6; reference
`g1_centroidal_mpc/config/mpc/task.info:1-447`, `config/command/reference.info:1-62`,
`humanoid_common_mpc/config/command/gait.info`) so the reference robot packs
load verbatim. Replaces `ModelSettings` (reference `ModelSettings.cpp:103-183`)
and the scattered `loadData::loadPtreeValue` call sites.

A numpy copy of `wb_humanoid_mpc_tpu/core/config.py`: the PyTorch port
imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from wb_humanoid_mpc_tpu_torch.core.info_parser import as_matrix, as_vector, get_path, load_info


@dataclasses.dataclass
class FootConstraintConfig:
    """Error-feedback gains for stance/swing foot constraints
    (reference `ModelSettings.h:45-54`)."""
    position_error_gain_z: float = 0.0
    orientation_error_gain: float = 0.0
    linear_velocity_error_gain_z: float = 0.0
    linear_velocity_error_gain_xy: float = 0.0
    angular_velocity_error_gain: float = 0.0
    linear_acceleration_error_gain_z: float = 0.0
    linear_acceleration_error_gain_xy: float = 0.0
    angular_acceleration_error_gain: float = 0.0


@dataclasses.dataclass
class ModelSettings:
    robot_name: str
    fixed_joint_names: list[str]
    contact_names: list[str]            # e.g. [foot_l_contact, foot_r_contact]
    contact_parent_joint_names: list[str]
    arm_joint_names: dict[str, str]     # role -> joint name (arm swing reference)
    foot_constraint: FootConstraintConfig
    phase_transition_stance_time: float = 0.0


@dataclasses.dataclass
class SwingTrajectoryConfig:
    """(reference `SwingTrajectoryPlanner.h:42-52`)"""
    lift_off_velocity: float = 0.05
    touch_down_velocity: float = 0.0
    swing_height: float = 0.08
    touch_down_height_offset: float = -0.001
    swing_time_scale: float = 0.4
    impact_proximity_factor_lift_off_velocity: float = -0.15
    impact_proximity_factor_touch_down_velocity: float = 0.3
    impact_proximity_factor_mid_point_value: float = 0.0


@dataclasses.dataclass
class SqpSettings:
    """multiple_shooting block (reference `task.info:79-96`)."""
    dt: float = 0.02
    sqp_iteration: int = 1
    delta_tol: float = 1e-4
    g_max: float = 1e-2
    g_min: float = 1e-6
    inequality_constraint_mu: float = 0.1
    inequality_constraint_delta: float = 5.0
    project_state_input_equality_constraints: bool = True
    integrator_type: str = "RK4"
    n_threads: int = 4  # informational; the solver batches over nodes instead


@dataclasses.dataclass
class MpcSettings:
    """(reference `task.info:109-120`)"""
    time_horizon: float = 1.2
    solution_time_window: float = -1.0
    cold_start: bool = False
    mpc_desired_frequency: float = 80.0
    mrt_desired_frequency: float = 100.0


@dataclasses.dataclass
class RelaxedBarrierConfig:
    mu: float
    delta: float


@dataclasses.dataclass
class ContactsConfig:
    contact_frame_translation: np.ndarray      # offset from parent joint
    rectangle_x_max: float
    rectangle_x_min: float
    rectangle_y_max: float
    rectangle_y_min: float
    friction_coefficient: float
    friction_cone_barrier: RelaxedBarrierConfig
    contact_moment_barrier: RelaxedBarrierConfig


@dataclasses.dataclass
class CollisionConfig:
    left_ankle_frame: str
    right_ankle_frame: str
    foot_radius: float
    left_knee_frame: str
    right_knee_frame: str
    knee_radius: float
    barrier: RelaxedBarrierConfig


@dataclasses.dataclass
class TaskSpaceCostConfig:
    link_name: str
    weights: np.ndarray  # 18-dim: pos(3), orientation(3), lin_vel(3), ang_vel(3), lin_acc(3), ang_acc(3)


@dataclasses.dataclass
class LegTorqueCostConfig:
    active_joint_names: list[str]
    weights: np.ndarray


_TS_KEYS = [
    "pos_x", "pos_y", "pos_z",
    "orientation_x", "orientation_y", "orientation_z",
    "lin_velocity_x", "lin_velocity_y", "lin_velocity_z",
    "ang_velocity_x", "ang_velocity_y", "ang_velocity_z",
    "lin_acceleration_x", "lin_acceleration_y", "lin_acceleration_z",
    "ang_acceleration_x", "ang_acceleration_y", "ang_acceleration_z",
]


@dataclasses.dataclass
class MimicJointConfig:
    """q_child = multiplier * q_parent (reference `CentroidalMpcInterface.cpp:277-313`,
    `WBMpcInterface.cpp:233-272`)."""
    parent_joint_name: str
    child_joint_name: str
    multiplier: float
    position_gain: float
    velocity_gain: float = 0.0


@dataclasses.dataclass
class TaskConfig:
    formulation: str                    # "centroidal" | "wb"
    centroidal_model_type: int          # 0 full, 1 SRBM (centroidal only)
    model_settings: ModelSettings
    swing: SwingTrajectoryConfig
    sqp: SqpSettings
    mpc: MpcSettings
    initial_state: np.ndarray
    Q: np.ndarray                       # diagonal (state dim)
    R: np.ndarray                       # diagonal (input dim)
    Q_final: np.ndarray
    terminal_cost_scaling: float
    icp_error_weight: float
    task_space_foot_cost_weights: np.ndarray        # 18-dim
    task_space_costs: dict[str, TaskSpaceCostConfig]
    leg_torque_costs: dict[str, LegTorqueCostConfig]
    contacts: ContactsConfig
    joint_limits_barrier: RelaxedBarrierConfig
    collision: CollisionConfig
    mimic_joints: list = dataclasses.field(default_factory=list)
    joint_torque_weights: np.ndarray | None = None


def _ts_weights(block: dict | None) -> np.ndarray:
    if not block:
        return np.zeros(len(_TS_KEYS))
    return np.array([float(block.get(k, 0.0)) for k in _TS_KEYS])


def load_task_config(path: str, formulation: str, state_dim: int, input_dim: int) -> TaskConfig:
    t = load_info(path)

    ms = t["model_settings"]
    fc = ms.get("foot_constraint", {})
    foot = FootConstraintConfig(
        position_error_gain_z=float(fc.get("positionErrorGain_z", 0.0)),
        orientation_error_gain=float(fc.get("orientationErrorGain", 0.0)),
        linear_velocity_error_gain_z=float(fc.get("linearVelocityErrorGain_z", 0.0)),
        linear_velocity_error_gain_xy=float(fc.get("linearVelocityErrorGain_xy", 0.0)),
        angular_velocity_error_gain=float(fc.get("angularVelocityErrorGain", 0.0)),
        linear_acceleration_error_gain_z=float(fc.get("linearAccelerationErrorGain_z", 0.0)),
        linear_acceleration_error_gain_xy=float(fc.get("linearAccelerationErrorGain_xy", 0.0)),
        angular_acceleration_error_gain=float(fc.get("angularAccelerationErrorGain", 0.0)),
    )
    arm_block = ms.get("armJointNames", {}) or {}
    arm = {k: v for k, v in arm_block.items() if not k.startswith("_")}
    model_settings = ModelSettings(
        robot_name=str(ms.get("robotName", "robot")),
        fixed_joint_names=[str(s) for s in as_vector(ms.get("fixedJointNames"))],
        contact_names=[str(s) for s in as_vector(ms.get("contactNames6DoF"))],
        contact_parent_joint_names=[str(s) for s in as_vector(ms.get("contactParentJointNames"))],
        arm_joint_names=arm,
        foot_constraint=foot,
        phase_transition_stance_time=float(ms.get("phaseTransitionStanceTime", 0.0)),
    )

    sw = t.get("swing_trajectory_config", {})
    swing = SwingTrajectoryConfig(
        lift_off_velocity=float(sw.get("liftOffVelocity", 0.05)),
        touch_down_velocity=float(sw.get("touchDownVelocity", 0.0)),
        swing_height=float(sw.get("swingHeight", 0.08)),
        touch_down_height_offset=float(sw.get("touchDownHeightOffset", -0.001)),
        swing_time_scale=float(sw.get("swingTimeScale", 0.4)),
        impact_proximity_factor_lift_off_velocity=float(sw.get("impactProximityFactorLiftOffVelocity", -0.15)),
        impact_proximity_factor_touch_down_velocity=float(sw.get("impactProximityFactorTouchDownVelocity", 0.3)),
        impact_proximity_factor_mid_point_value=float(sw.get("impactProximityFactorMidPointValue", 0.0)),
    )

    msh = t.get("multiple_shooting", {})
    sqp = SqpSettings(
        dt=float(msh.get("dt", 0.02)),
        sqp_iteration=int(msh.get("sqpIteration", 1)),
        delta_tol=float(msh.get("deltaTol", 1e-4)),
        g_max=float(msh.get("g_max", 1e-2)),
        g_min=float(msh.get("g_min", 1e-6)),
        inequality_constraint_mu=float(msh.get("inequalityConstraintMu", 0.1)),
        inequality_constraint_delta=float(msh.get("inequalityConstraintDelta", 5.0)),
        project_state_input_equality_constraints=bool(
            msh.get("projectStateInputEqualityConstraints", True)),
        integrator_type=str(msh.get("integratorType", "RK4")),
        n_threads=int(msh.get("nThreads", 4)),
    )

    mp = t.get("mpc", {})
    mpc = MpcSettings(
        time_horizon=float(mp.get("timeHorizon", 1.2)),
        solution_time_window=float(mp.get("solutionTimeWindow", -1.0)),
        cold_start=bool(mp.get("coldStart", False)),
        mpc_desired_frequency=float(mp.get("mpcDesiredFrequency", 80.0)),
        mrt_desired_frequency=float(mp.get("mrtDesiredFrequency", 100.0)),
    )

    co = t["contacts"]
    tr = co.get("contact_frame_translation", {})
    rect = co.get("contact_rectangle", {})
    fr = co.get("frictionForceConeSoftConstraint", {})
    cm = co.get("contactMomentXYSoftConstraint", {})
    contacts = ContactsConfig(
        contact_frame_translation=np.array(
            [float(tr.get("x", 0.0)), float(tr.get("y", 0.0)), float(tr.get("z", 0.0))]),
        rectangle_x_max=float(rect.get("x_max", 0.1)),
        rectangle_x_min=float(rect.get("x_min", -0.1)),
        rectangle_y_max=float(rect.get("y_max", 0.05)),
        rectangle_y_min=float(rect.get("y_min", -0.05)),
        friction_coefficient=float(fr.get("frictionCoefficient", 0.4)),
        friction_cone_barrier=RelaxedBarrierConfig(
            mu=float(fr.get("mu", 0.2)), delta=float(fr.get("delta", 5.0))),
        contact_moment_barrier=RelaxedBarrierConfig(
            mu=float(cm.get("mu", 0.6)), delta=float(cm.get("delta", 0.03))),
    )

    jl = t.get("jointLimits", {})
    joint_limits = RelaxedBarrierConfig(mu=float(jl.get("mu", 0.1)), delta=float(jl.get("delta", 0.1)))

    cc = t.get("collision_constraint", {})
    foot_cc = cc.get("foot", {})
    knee_cc = cc.get("knee", {})
    collision = CollisionConfig(
        left_ankle_frame=str(foot_cc.get("leftAnkleFrame", "left_ankle_roll_joint")),
        right_ankle_frame=str(foot_cc.get("rightAnkleFrame", "right_ankle_roll_joint")),
        foot_radius=float(foot_cc.get("footCollisionSphereRadius", 0.05)),
        left_knee_frame=str(knee_cc.get("leftKneeFrame", "left_knee_joint")),
        right_knee_frame=str(knee_cc.get("rightKneeFrame", "right_knee_joint")),
        knee_radius=float(knee_cc.get("kneeCollisionSphereRadius", 0.07)),
        barrier=RelaxedBarrierConfig(mu=float(cc.get("mu", 30000.0)), delta=float(cc.get("delta", 0.05))),
    )

    ts_costs = {}
    for name, block in (t.get("task_space_costs") or {}).items():
        if isinstance(block, dict) and "link_name" in block:
            ts_costs[name] = TaskSpaceCostConfig(
                link_name=str(block["link_name"]),
                weights=_ts_weights(block.get("weights")),
            )

    leg_costs = {}
    for key in ("left_leg_torque_cost", "right_leg_torque_cost"):
        block = t.get(key)
        if block:
            names = [str(s) for s in as_vector(block.get("activeJointNames"))]
            leg_costs[key] = LegTorqueCostConfig(
                active_joint_names=names,
                weights=as_matrix(block.get("weights", {}), len(names)),
            )

    mimics = []
    for key, block in (t.get("mimicJoints") or {}).items():
        if isinstance(block, dict) and "parentJointName" in block:
            mimics.append(MimicJointConfig(
                parent_joint_name=str(block["parentJointName"]),
                child_joint_name=str(block["childJointName"]),
                multiplier=float(block.get("multiplier", 1.0)),
                position_gain=float(block.get("positionGain", 0.0)),
                velocity_gain=float(block.get("velocityGain", 0.0)),
            ))

    jtw = t.get("joint_torque_weights")
    joint_torque_weights = (as_matrix(jtw, input_dim - 12)
                            if isinstance(jtw, dict) else None)

    return TaskConfig(
        formulation=formulation,
        centroidal_model_type=int(t.get("centroidalModelType", 0)),
        model_settings=model_settings,
        swing=swing,
        sqp=sqp,
        mpc=mpc,
        initial_state=as_matrix(t.get("initialState", {}), state_dim),
        Q=as_matrix(t.get("Q", {}), state_dim, state_dim).diagonal().copy(),
        R=as_matrix(t.get("R", {}), input_dim, input_dim).diagonal().copy(),
        Q_final=as_matrix(t.get("Q_final", {}), state_dim, state_dim).diagonal().copy(),
        terminal_cost_scaling=float(t.get("terminalCostScaling", 1.0)),
        icp_error_weight=float(get_path(t, "icp_cost_weights.icpErrorWeight", 0.0)),
        task_space_foot_cost_weights=_ts_weights(t.get("task_space_foot_cost_weights")),
        task_space_costs=ts_costs,
        leg_torque_costs=leg_costs,
        contacts=contacts,
        joint_limits_barrier=joint_limits,
        collision=collision,
        mimic_joints=mimics,
        joint_torque_weights=joint_torque_weights,
    )


@dataclasses.dataclass
class ModeSequenceTemplate:
    """Periodic gait template (reference `ModeSequenceTemplate.h:47-70`)."""
    switching_times: np.ndarray   # len K+1
    mode_sequence: np.ndarray     # int modes, len K

    @property
    def duration(self) -> float:
        return float(self.switching_times[-1] - self.switching_times[0])


MODE_NAMES = {"FLY": 0, "RF": 1, "LF": 2, "STANCE": 3}
MODE_STRINGS = {v: k for k, v in MODE_NAMES.items()}


def _parse_template(block: dict) -> ModeSequenceTemplate:
    modes = [MODE_NAMES[str(s)] for s in as_vector(block.get("modeSequence"))]
    times_key = "switchingTimes" if "switchingTimes" in block else "eventTimes"
    times = [float(x) for x in as_vector(block.get(times_key))]
    return ModeSequenceTemplate(np.array(times), np.array(modes, dtype=np.int32))


@dataclasses.dataclass
class ReferenceConfig:
    """(reference `reference.info:1-62`)"""
    target_displacement_velocity: float
    target_rotation_velocity: float
    max_displacement_velocity_x: float
    max_displacement_velocity_y: float
    max_delta_pelvis_height: float
    max_rotation_velocity: float
    default_base_height: float
    default_joint_state: np.ndarray
    initial_mode_schedule_modes: np.ndarray
    initial_mode_schedule_times: np.ndarray
    default_template: ModeSequenceTemplate


def load_reference_config(path: str, n_joints: int) -> ReferenceConfig:
    r = load_info(path)
    ims = r.get("initialModeSchedule", {})
    init_modes = np.array([MODE_NAMES[str(s)] for s in as_vector(ims.get("modeSequence"))], dtype=np.int32)
    init_times = np.array([float(x) for x in as_vector(ims.get("eventTimes"))])
    return ReferenceConfig(
        target_displacement_velocity=float(r.get("targetDisplacementVelocity", 0.5)),
        target_rotation_velocity=float(r.get("targetRotationVelocity", 0.5)),
        max_displacement_velocity_x=float(r.get("maxDisplacementVelocityX", 1.0)),
        max_displacement_velocity_y=float(r.get("maxDisplacementVelocityY", 0.5)),
        max_delta_pelvis_height=float(r.get("maxDeltaPelvisHeight", 0.4)),
        max_rotation_velocity=float(r.get("maxRotationVelocity", 1.0)),
        default_base_height=float(r.get("defaultBaseHeight", 0.79)),
        default_joint_state=as_matrix(r.get("defaultJointState", {}), n_joints),
        initial_mode_schedule_modes=init_modes,
        initial_mode_schedule_times=init_times,
        default_template=_parse_template(r.get("defaultModeSequenceTemplate", {})),
    )


def load_gait_library(path: str) -> dict[str, ModeSequenceTemplate]:
    """(reference `gait.info`, loader `GaitSchedule.cpp:151`)"""
    g = load_info(path)
    names = [str(s) for s in as_vector(g.get("list"))]
    return {n: _parse_template(g[n]) for n in names if n in g}
