"""URDF -> kinematic/dynamic model description (numpy, host-side, trace-time).

Replaces the reference's Pinocchio model factory
(reference: `humanoid_common_mpc/src/pinocchio_model/createPinocchioModel.cpp`):

- floating base = world translation + euler-ZYX rotation (6 generalized coords,
  generalized velocity == coordinate rates; reference `createPinocchioModel.cpp:59-66`
  uses `JointModelTranslation` + `JointModelSphericalZYX`),
- every URDF joint not in the MPC joint set is treated as FIXED and its inertia
  is lumped into the nearest moving parent body (reference `:156-164`),
- fixed frames (link frames + injected contact/collision frames) are stored as
  (parent moving body, constant transform) pairs (reference `:76-130`).

The output `RobotModel` holds only plain numpy constants; the PyTorch port
turns them into device tensors once per (device, dtype)
(`models/kinematics.py::robot_tensors`).

A numpy copy of `wb_humanoid_mpc_tpu/models/robot/urdf.py`: the parsed arrays
are identical (tests/test_torch_model.py).

Joint ordering follows document-order DFS of the URDF tree, which reproduces
Pinocchio's ordering for the G1 (left leg, right leg, waist, left arm, right
arm — validated in tests against the reference's `initialState` listing).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


def _parse_vec(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.array(default, dtype=np.float64)
    return np.array([float(v) for v in s.split()], dtype=np.float64)


def _rpy_to_rot_np(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _skew_np(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


@dataclasses.dataclass
class _UrdfJoint:
    name: str
    jtype: str
    parent_link: str
    child_link: str
    R: np.ndarray  # rotation parent-link frame -> joint(child-link) frame
    p: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float
    velocity: float
    effort: float


@dataclasses.dataclass
class _UrdfLink:
    name: str
    mass: float
    com: np.ndarray          # com position in link frame
    inertia_com: np.ndarray  # 3x3 inertia about com, in link frame axes


@dataclasses.dataclass(frozen=True)
class Frame:
    """A fixed frame rigidly attached to a moving body."""
    name: str
    body: int          # moving-body index (0 = base)
    R: np.ndarray      # body frame -> this frame rotation
    p: np.ndarray      # frame origin in body frame


@dataclasses.dataclass
class RobotModel:
    """Fixed-size articulated model with floating (translation + euler-ZYX) base.

    Bodies: body 0 = root (base) link; body j+1 = child link of moving joint j.
    Generalized coordinates q (dim 6+n_j): [p_world(3), theta_zyx(3), q_joints].
    Generalized velocity = dq/dt (world linear velocity, euler rates, joint rates).
    """

    name: str
    joint_names: list[str]
    # per moving joint:
    joint_parent_body: np.ndarray      # int[n_j]
    joint_R: np.ndarray                # float[n_j,3,3] parent-body->joint frame
    joint_p: np.ndarray                # float[n_j,3]
    joint_axis: np.ndarray             # float[n_j,3] (in joint frame)
    joint_lower: np.ndarray            # float[n_j]
    joint_upper: np.ndarray
    joint_velocity_limit: np.ndarray
    joint_effort_limit: np.ndarray
    # per body (n_b = n_j + 1):
    body_names: list[str]
    mass: np.ndarray                   # float[n_b]
    com: np.ndarray                    # float[n_b,3] in body frame
    inertia_o: np.ndarray              # float[n_b,3,3] about body origin
    # ancestor mask over generalized coords: anc[b, 6+j] = coord affects body b
    ancestor_mask: np.ndarray          # bool[n_b, 6+n_j]
    frames: dict[str, Frame]
    gravity: float = 9.81
    # device tensors derived from the arrays above, one set per (device,
    # dtype) (`models/kinematics.py::robot_tensors`); not part of the model
    tensor_cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def n_bodies(self) -> int:
        return self.n_joints + 1

    @property
    def nq(self) -> int:
        return 6 + self.n_joints

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def add_frame(self, name: str, parent_frame: str, p_offset, R_offset=None) -> None:
        """Attach a new fixed frame at an offset from an existing frame.

        Mirrors the reference's contact/collision frame injection
        (reference `createPinocchioModel.cpp:76-130`).
        """
        parent = self.frames[parent_frame]
        R_offset = np.eye(3) if R_offset is None else np.asarray(R_offset, dtype=np.float64)
        p_offset = np.asarray(p_offset, dtype=np.float64)
        self.frames[name] = Frame(
            name=name,
            body=parent.body,
            R=parent.R @ R_offset,
            p=parent.p + parent.R @ p_offset,
        )


def _parse_urdf(urdf_path: str) -> tuple[dict[str, _UrdfLink], list[_UrdfJoint], str]:
    root = ET.parse(urdf_path).getroot()

    links: dict[str, _UrdfLink] = {}
    for link_el in root.findall("link"):
        name = link_el.attrib["name"]
        inertial = link_el.find("inertial")
        if inertial is None:
            links[name] = _UrdfLink(name, 0.0, np.zeros(3), np.zeros((3, 3)))
            continue
        origin = inertial.find("origin")
        xyz = _parse_vec(origin.attrib.get("xyz") if origin is not None else None)
        rpy = _parse_vec(origin.attrib.get("rpy") if origin is not None else None)
        mass = float(inertial.find("mass").attrib["value"])
        it = inertial.find("inertia").attrib
        I = np.array(
            [
                [float(it["ixx"]), float(it["ixy"]), float(it["ixz"])],
                [float(it["ixy"]), float(it["iyy"]), float(it["iyz"])],
                [float(it["ixz"]), float(it["iyz"]), float(it["izz"])],
            ]
        )
        R = _rpy_to_rot_np(rpy)
        links[name] = _UrdfLink(name, mass, xyz, R @ I @ R.T)

    joints: list[_UrdfJoint] = []
    child_links = set()
    for j in root.findall("joint"):
        name = j.attrib["name"]
        jtype = j.attrib["type"]
        parent = j.find("parent").attrib["link"]
        child = j.find("child").attrib["link"]
        origin = j.find("origin")
        xyz = _parse_vec(origin.attrib.get("xyz") if origin is not None else None)
        rpy = _parse_vec(origin.attrib.get("rpy") if origin is not None else None)
        axis_el = j.find("axis")
        axis = _parse_vec(axis_el.attrib.get("xyz") if axis_el is not None else None, (1.0, 0.0, 0.0))
        limit = j.find("limit")
        lower = float(limit.attrib.get("lower", -np.inf)) if limit is not None else -np.inf
        upper = float(limit.attrib.get("upper", np.inf)) if limit is not None else np.inf
        vel = float(limit.attrib.get("velocity", np.inf)) if limit is not None else np.inf
        eff = float(limit.attrib.get("effort", np.inf)) if limit is not None else np.inf
        joints.append(
            _UrdfJoint(name, jtype, parent, child, _rpy_to_rot_np(rpy), xyz, axis, lower, upper, vel, eff)
        )
        child_links.add(child)

    roots = [l for l in links if l not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected a unique root link, found {roots}")
    return links, joints, roots[0]


def load_robot_model(
    urdf_path: str,
    moving_joint_names: list[str] | None = None,
    name: str = "robot",
) -> RobotModel:
    """Build a :class:`RobotModel` from a URDF file.

    ``moving_joint_names``: joints kept articulated; all other joints are
    fixed and lumped (reference `createPinocchioModel.cpp:156-164`). ``None``
    keeps every revolute/continuous/prismatic joint.
    """
    links, joints, root_link = _parse_urdf(urdf_path)
    by_parent: dict[str, list[_UrdfJoint]] = {}
    for j in joints:
        by_parent.setdefault(j.parent_link, []).append(j)

    def is_moving(j: _UrdfJoint) -> bool:
        if j.jtype not in ("revolute", "continuous", "prismatic"):
            return False
        return moving_joint_names is None or j.name in moving_joint_names

    # DFS in document order; track (link, moving parent body idx, transform from
    # that body's frame to this link's frame).
    joint_rows: list[_UrdfJoint] = []
    joint_parent_body: list[int] = []
    joint_R: list[np.ndarray] = []
    joint_p: list[np.ndarray] = []
    body_links: list[str] = [root_link]
    frames: dict[str, Frame] = {root_link: Frame(root_link, 0, np.eye(3), np.zeros(3))}

    # composite inertia accumulators per body: mass, first moment h = m*c, I about origin
    n_guess = 1 + sum(1 for j in joints if is_moving(j))
    masses = [0.0] * n_guess
    hs = [np.zeros(3) for _ in range(n_guess)]
    Is = [np.zeros((3, 3)) for _ in range(n_guess)]

    def lump(body: int, R: np.ndarray, p: np.ndarray, link: _UrdfLink) -> None:
        if link.mass == 0.0:
            return
        c = R @ link.com + p
        Ic = R @ link.inertia_com @ R.T
        masses[body] += link.mass
        hs[body] += link.mass * c
        Is[body] += Ic + link.mass * (np.dot(c, c) * np.eye(3) - np.outer(c, c))

    stack = [(root_link, 0, np.eye(3), np.zeros(3))]
    # we need document order: process children in order => use explicit recursion
    def visit(link_name: str, body: int, R: np.ndarray, p: np.ndarray) -> None:
        lump(body, R, p, links[link_name])
        for j in by_parent.get(link_name, []):
            Rj = R @ j.R
            pj = p + R @ j.p
            if is_moving(j):
                jidx = len(joint_rows)
                joint_rows.append(j)
                joint_parent_body.append(body)
                joint_R.append(Rj)
                joint_p.append(pj)
                body_links.append(j.child_link)
                new_body = jidx + 1
                frames[j.child_link] = Frame(j.child_link, new_body, np.eye(3), np.zeros(3))
                # also register a frame at the joint itself (== child link frame)
                frames[j.name] = Frame(j.name, new_body, np.eye(3), np.zeros(3))
                visit(j.child_link, new_body, np.eye(3), np.zeros(3))
            else:
                frames[j.child_link] = Frame(j.child_link, body, Rj, pj)
                frames[j.name] = Frame(j.name, body, Rj, pj)
                visit(j.child_link, body, Rj, pj)

    del stack
    visit(root_link, 0, np.eye(3), np.zeros(3))

    if moving_joint_names is not None:
        got = [j.name for j in joint_rows]
        missing = set(moving_joint_names) - set(got)
        if missing:
            raise ValueError(f"moving joints not found in URDF: {sorted(missing)}")

    n_j = len(joint_rows)
    n_b = n_j + 1
    mass = np.array(masses[:n_b])
    com = np.stack([hs[b] / masses[b] if masses[b] > 0 else np.zeros(3) for b in range(n_b)])
    inertia_o = np.stack(Is[:n_b])

    # ancestor mask: base coords affect every body; joint j affects body b iff
    # joint j is on the path from base to b.
    anc = np.zeros((n_b, 6 + n_j), dtype=bool)
    anc[:, :6] = True
    for jidx in range(n_j):
        b = jidx + 1
        anc[b, 6 + jidx] = True
        # propagate: walk up from parent body
        pb = joint_parent_body[jidx]
        anc[b, 6:] |= anc[pb, 6:]
    # fix: above builds each body's mask from its parent (processed earlier since
    # parents always precede children in DFS index order).

    return RobotModel(
        name=name,
        joint_names=[j.name for j in joint_rows],
        joint_parent_body=np.array(joint_parent_body, dtype=np.int32),
        joint_R=np.stack(joint_R) if n_j else np.zeros((0, 3, 3)),
        joint_p=np.stack(joint_p) if n_j else np.zeros((0, 3)),
        joint_axis=np.stack([j.axis for j in joint_rows]) if n_j else np.zeros((0, 3)),
        joint_lower=np.array([j.lower for j in joint_rows]),
        joint_upper=np.array([j.upper for j in joint_rows]),
        joint_velocity_limit=np.array([j.velocity for j in joint_rows]),
        joint_effort_limit=np.array([j.effort for j in joint_rows]),
        body_names=body_links,
        mass=mass,
        com=com,
        inertia_o=inertia_o,
        ancestor_mask=anc,
        frames=frames,
    )


def full_joint_list(urdf_path: str) -> list[str]:
    """All articulated joint names in tree DFS order (the 'full model' order,
    reference `ModelSettings.cpp:134-141`)."""
    return load_robot_model(urdf_path).joint_names
