"""Visualization layer (the `HumanoidVisualizer` equivalent, headless-first).

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/viz/visualizer.py`: host
numpy and matplotlib around the port's forward kinematics, evaluated on the
CPU in float64 (a drawing needs no device). matplotlib and mujoco are
imported only where a figure or a frame is made.

The reference publishes to RViz (`HumanoidVisualizer.cpp:109-114`: joint
states for current/terminal/target robots, TF, foot spheres, contact corner
force arrows via the wrench -> corner-force map, CoP, optimized state
trajectory). Without a ROS graph, this module provides:

- `TrajectoryVisualizer.render_frames`: offscreen MuJoCo renders of a policy
  rollout (EGL/OSMesa when available; returns None when no GL).
- `TrajectoryVisualizer.export_summary`: a self-contained matplotlib summary
  (base path, foot heights, contact schedule, force profiles) — the headless
  stand-in for the RViz scene.
- `contact_corner_forces`: the reference's `ContactWrenchMapper<4>`
  pseudo-inverse wrench -> 4 corner forces (reference
  `contact/ContactWrenchMapper.h:46-84`), used for force display.
"""

from __future__ import annotations

import numpy as np


def contact_corner_forces(wrench: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Map a 6D contact wrench to equivalent vertical+tangential forces at the
    polygon corners via least squares (reference `ContactWrenchMapper.h:46-84`).

    wrench: [fx,fy,fz,tx,ty,tz] at the contact center (local frame);
    corners: [4,3] corner offsets from the center. Returns [4,3] forces.
    """
    n_c = corners.shape[0]
    # rows: force balance (3) + torque balance (3); unknowns: 3 per corner
    A = np.zeros((6, 3 * n_c))
    for i, c in enumerate(corners):
        A[0:3, 3 * i: 3 * i + 3] = np.eye(3)
        cx, cy, cz = c
        A[3:6, 3 * i: 3 * i + 3] = np.array([
            [0.0, -cz, cy],
            [cz, 0.0, -cx],
            [-cy, cx, 0.0],
        ])
    f = np.linalg.pinv(A) @ wrench
    return f.reshape(n_c, 3)


def contacts_cop(positions_w: np.ndarray, wrenches: np.ndarray) -> np.ndarray | None:
    """Center of pressure over the stance contacts (reference
    `DynamicsHelperFunctions` `computeContactsCoP`): per-contact CoP offset
    [-ty/fz, tx/fz] from the local moments, averaged weighted by normal force.
    Returns None when no contact carries load."""
    fz = wrenches[:, 2]
    total = float(np.sum(fz))
    if total <= 1e-6:
        return None
    cop = np.zeros(3)
    for p, w in zip(positions_w, wrenches):
        if w[2] <= 1e-6:
            continue
        local = np.array([-w[4] / w[2], w[3] / w[2], 0.0])
        cop += w[2] * (p + local)
    return cop / total


def _fk(robot, q):
    """The port's forward kinematics of one configuration, float64 on the CPU."""
    import torch

    from wb_humanoid_mpc_tpu_torch.models.kinematics import forward_kinematics

    return forward_kinematics(robot, torch.as_tensor(np.asarray(q, dtype=np.float64)))


def _skeleton_segments(robot, q: np.ndarray) -> np.ndarray:
    """[n_joints, 2, 3] world segments parent-body-origin -> child-body-origin
    from one FK pass (viz analogue of the RViz robot_state_publisher chain)."""
    p = _fk(robot, q).p.numpy()
    parents = np.asarray(robot.joint_parent_body)
    return np.stack([p[parents], p[1:]], axis=1)


def render_scene(model, x_current, policy=None, x_target=None,
                 u_current=None, out_path: str = "scene.png") -> str:
    """Headless RViz-scene analogue (reference `HumanoidVisualizer.cpp:109-114`
    publishes current/terminal/target robot joint states, foot markers, CoP,
    corner force arrows and the optimized base trajectory; here they render
    into one 3-D matplotlib scene).

    model: Centroidal/WB MPC robot model (`.layout`, `.robot`);
    x_current: current MPC state; policy: optional solver policy (terminal
    state + optimized base path); x_target: optional target state;
    u_current: optional input for corner-force arrows + CoP.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from wb_humanoid_mpc_tpu_torch.models.kinematics import frame_transform

    lay = model.layout
    robot = model.robot
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")

    def draw_robot(x, color, label, lw=2.0, alpha=1.0):
        q = np.asarray(lay.generalized_coordinates(np.asarray(x)))
        for seg in _skeleton_segments(robot, q):
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color, lw=lw,
                    alpha=alpha)
        ax.plot([], [], color=color, lw=lw, alpha=alpha, label=label)
        return q

    q_cur = draw_robot(x_current, "tab:blue", "current")
    if policy is not None:
        draw_robot(policy.xs[-1], "tab:orange", "terminal (optimized)",
                   lw=1.2, alpha=0.7)
        base_traj = np.stack([
            np.asarray(lay.base_position(np.asarray(x))) for x in policy.xs])
        ax.plot(base_traj[:, 0], base_traj[:, 1], base_traj[:, 2],
                "k--", lw=1.0, label="optimized base path")
    if x_target is not None:
        draw_robot(x_target, "tab:green", "target", lw=1.2, alpha=0.7)

    # foot polygons, corner forces, CoP for the CURRENT configuration
    fk = _fk(robot, q_cur)
    contact_names = list(getattr(model, "contact_frames", [])) or [
        n for n in robot.frames if n.endswith("_contact")]
    contact_pos, wrenches = [], []
    for ci, cname in enumerate(contact_names):
        Rc, pc = frame_transform(robot, fk, cname)
        Rc, pc = Rc.numpy(), pc.numpy()
        contact_pos.append(pc)
        corners_w = []
        for i in range(4):
            _, pcorner = frame_transform(robot, fk, f"{cname}_p_{i}")
            corners_w.append(pcorner.numpy())
        poly = np.asarray(corners_w + [corners_w[0]])
        ax.plot(poly[:, 0], poly[:, 1], poly[:, 2], color="tab:red", lw=1.0)
        if u_current is not None:
            w_local = np.asarray(lay.contact_wrench(np.asarray(u_current), ci))
            wrenches.append(w_local)
            corner_f = contact_corner_forces(
                w_local, np.asarray(corners_w) - pc)
            for p0, f in zip(corners_w, corner_f):
                f_w = Rc @ f
                ax.quiver(p0[0], p0[1], p0[2],
                          f_w[0], f_w[1], f_w[2],
                          length=1e-3, color="tab:purple", normalize=False)
    if wrenches:
        cop = contacts_cop(np.asarray(contact_pos), np.asarray(wrenches))
        if cop is not None:
            ax.scatter([cop[0]], [cop[1]], [cop[2]], color="black", s=40,
                       marker="x", label="CoP")

    ax.legend(loc="upper left", fontsize=8)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    # equal-ish aspect around the robot
    c = np.asarray(lay.base_position(np.asarray(x_current)))
    ax.set_xlim(c[0] - 0.8, c[0] + 0.8)
    ax.set_ylim(c[1] - 0.8, c[1] + 0.8)
    ax.set_zlim(0.0, 1.6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


class TrajectoryVisualizer:
    def __init__(self, mjcf_path: str | None = None):
        self.mjcf_path = mjcf_path

    def render_frames(self, qpos_traj: np.ndarray, width=640, height=480,
                      camera=-1, every=1):
        """Offscreen MuJoCo renders; returns list of RGB arrays or None if no
        GL context is available in this environment."""
        if self.mjcf_path is None:
            return None
        try:
            import mujoco

            model = mujoco.MjModel.from_xml_path(self.mjcf_path)
            data = mujoco.MjData(model)
            renderer = mujoco.Renderer(model, height=height, width=width)
        except Exception:
            return None
        frames = []
        for qpos in qpos_traj[::every]:
            data.qpos[: len(qpos)] = qpos
            mujoco.mj_forward(model, data)
            renderer.update_scene(data, camera=camera)
            frames.append(renderer.render().copy())
        return frames

    @staticmethod
    def export_summary(log, out_path: str, state_z_index: int = 8) -> str:
        """Matplotlib summary of a dummy-sim / closed-loop log."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.asarray(log.times)
        x = np.asarray(log.states) if hasattr(log, "states") else None

        fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
        if x is not None:
            axes[0].plot(t, x[:, state_z_index - 2], label="base x")
            axes[0].plot(t, x[:, state_z_index - 1], label="base y")
            axes[0].plot(t, x[:, state_z_index], label="base z")
            axes[0].legend()
            axes[0].set_ylabel("base pose [m]")
        if hasattr(log, "contact_flags"):
            cf = np.asarray(log.contact_flags)
            axes[1].step(t, cf[:, 0] * 1.0, label="left stance")
            axes[1].step(t, cf[:, 1] * 1.0 + 1.2, label="right stance")
            axes[1].legend()
            axes[1].set_ylabel("contact")
        if hasattr(log, "inputs"):
            u = np.asarray(log.inputs)
            axes[2].plot(t, u[:, 2], label="left fz")
            axes[2].plot(t, u[:, 8], label="right fz")
            axes[2].legend()
            axes[2].set_ylabel("force [N]")
        axes[-1].set_xlabel("time [s]")
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
