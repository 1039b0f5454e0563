"""Robot model factory: URDF + task config -> RobotModel with contact frames.

Analogue of `createCustomPinocchioInterface`
(reference `createPinocchioModel.cpp:140-184`): fixes non-MPC joints (inertia
lumping), injects per-contact frames — contact center, 2 collision probe
points, 4 polygon corner frames (reference `:76-130`,
`ContactRectangle.cpp:52-59` for corner ordering and `ContactPolygon.cpp:44`
for `<contact>_p_<i>` naming).

A copy of `wb_humanoid_mpc_tpu/models/robot/factory.py`.
"""

from __future__ import annotations

from wb_humanoid_mpc_tpu_torch.core.config import TaskConfig
from wb_humanoid_mpc_tpu_torch.models.robot.urdf import RobotModel, full_joint_list, load_robot_model


def mpc_joint_names(urdf_path: str, fixed_joint_names: list[str]) -> list[str]:
    """Full URDF DFS joint order minus fixed joints
    (reference `ModelSettings.cpp:134-141`)."""
    return [j for j in full_joint_list(urdf_path) if j not in fixed_joint_names]


def build_robot_model(urdf_path: str, cfg: TaskConfig, name: str | None = None) -> RobotModel:
    ms = cfg.model_settings
    joints = mpc_joint_names(urdf_path, ms.fixed_joint_names)
    model = load_robot_model(urdf_path, joints, name=name or ms.robot_name)

    tr = cfg.contacts.contact_frame_translation
    x_min, x_max = cfg.contacts.rectangle_x_min, cfg.contacts.rectangle_x_max
    y_min, y_max = cfg.contacts.rectangle_y_min, cfg.contacts.rectangle_y_max
    corners = [
        (x_min, y_min, 0.0),
        (x_max, y_min, 0.0),
        (x_max, y_max, 0.0),
        (x_min, y_max, 0.0),
    ]

    for contact_name, parent in zip(ms.contact_names, ms.contact_parent_joint_names):
        model.add_frame(contact_name, parent, tr)
        # collision probe points (reference createPinocchioModel.cpp:91-108)
        model.add_frame(f"{contact_name}_collision_p_1", parent, tr + [x_max * 0.6, 0.0, 0.0])
        model.add_frame(f"{contact_name}_collision_p_2", parent, tr + [x_min * 0.6, 0.0, 0.0])
        # polygon corners (reference createPinocchioModel.cpp:116-130)
        for i, c in enumerate(corners):
            model.add_frame(f"{contact_name}_p_{i}", parent, tr + list(c))

    return model
