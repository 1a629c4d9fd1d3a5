"""URDF-lite parser: URDF XML -> RobotModel.

PyTorch counterpart of ``aslr_to_tpu/utils/urdf.py`` (the
``example_robot_data`` / Pinocchio URDF loading of the reference,
``examples/two_dof_sea.py:18``) for fixed-base serial chains:
revolute and continuous joints with ``<origin>`` (xyz + rpy), ``<axis>``
and ``<inertial>`` (mass, the CoM's origin, the full inertia tensor), and
fixed joints, which become frames.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..ops.rigid_body import RobotModel


def _rpy_to_matrix(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _parse_origin(el):
    if el is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
    return _rpy_to_matrix(*rpy), xyz


def _parse_inertial(link_el):
    """(mass, CoM, inertia about the CoM in the link frame)."""
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    R, com = _parse_origin(inertial.find("origin"))
    iel = inertial.find("inertia")
    ixx, iyy, izz, ixy, ixz, iyz = (float(iel.get(k, 0))
                                    for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz"))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # the tensor is given in the inertial frame: rotate it into the link's
    return mass, com, R @ I @ R.T


def parse_urdf(source: str, gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
               device=None) -> RobotModel:
    """Parse a URDF string or file path into a RobotModel of ``dtype`` on
    ``device``. The robot must be a fixed-base serial chain of revolute or
    continuous joints; fixed joints become frames (under their own name and
    their child link's), every moving joint's child link is a frame too,
    and other joint types raise ``ValueError``."""
    if "<robot" not in source:
        with open(source) as f:
            source = f.read()
    root = ET.fromstring(source)
    name = root.get("name", "urdf_robot")

    links = {link.get("name"): link for link in root.findall("link")}
    joints = root.findall("joint")
    children = {j.find("child").get("link") for j in joints}
    roots = [ln for ln in links if ln not in children]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, got {roots}")
    by_parent = {}
    for j in joints:
        by_parent.setdefault(j.find("parent").get("link"), []).append(j)

    joint_pos, joint_rot, axes, masses, coms, inertias = [], [], [], [], [], []
    frames = []
    parent_joint = -1
    # the fixed joints' transform, applied to the next moving joint
    acc_R, acc_p = np.eye(3), np.zeros(3)
    link_name = roots[0]
    while True:
        js = by_parent.get(link_name, [])
        if not js:
            break
        if len(js) > 1:
            raise ValueError("branching kinematic trees are not supported")
        j = js[0]
        jtype = j.get("type")
        R, p = _parse_origin(j.find("origin"))
        R, p = acc_R @ R, acc_R @ p + acc_p
        child = j.find("child").get("link")
        if jtype == "fixed":
            at = max(parent_joint, 0)
            frames.append((j.get("name", child), at, R, p))
            frames.append((child, at, R, p))
            acc_R, acc_p = R, p
            link_name = child
            continue
        if jtype not in ("revolute", "continuous"):
            raise ValueError(f"unsupported joint type '{jtype}'")
        axis_el = j.find("axis")
        axis = np.array([float(v) for v in
                         (axis_el.get("xyz", "1 0 0") if axis_el is not None else "1 0 0").split()])
        mass, com, I = _parse_inertial(links[child])
        joint_pos.append(p)
        joint_rot.append(R)
        axes.append(axis / np.linalg.norm(axis))
        masses.append(mass)
        coms.append(com)
        inertias.append(I)
        parent_joint += 1
        acc_R, acc_p = np.eye(3), np.zeros(3)
        frames.append((child, parent_joint, np.eye(3), np.zeros(3)))
        link_name = child

    nj = len(masses)
    names, parents, f_rot, f_pos = [], [], [], []
    for fname, fparent, R, p in frames:
        if fname in names:
            continue
        names.append(fname)
        parents.append(min(fparent, nj - 1))
        f_rot.append(R)
        f_pos.append(p)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    return RobotModel(
        name=name,
        parents=tuple(range(-1, nj - 1)),
        frame_names=tuple(names),
        frame_parents=tuple(parents),
        joint_rot=t(np.stack(joint_rot)),
        joint_pos=t(np.stack(joint_pos)),
        axis=t(np.stack(axes)),
        mass=t(masses),
        com=t(np.stack(coms)),
        inertia=t(np.stack(inertias)),
        frame_rot=t(np.stack(f_rot)),
        frame_pos=t(np.stack(f_pos)),
        gravity=t(gravity),
    )
