"""Robot models: the serial-chain builder, the 2-DoF soft arm, the double
pendulum, the 7-DoF arm, and a name registry.

PyTorch counterpart of ``aslr_to_tpu/models/robots.py`` (``make_chain``,
``asr_twodof``, ``double_pendulum``, ``seven_dof_arm`` and ``load``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rigid_body import RobotModel


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def make_chain(name, joint_pos, joint_rot, axes, masses, coms, inertias,
               frames=(), gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
               device=None) -> RobotModel:
    """Build a serial-chain RobotModel (parent of joint i is i-1)."""
    nj = len(masses)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    inertia = []
    for I in inertias:
        I = np.asarray(I, dtype=np.float64)
        inertia.append(np.diag(I) if I.ndim == 1 else I)
    return RobotModel(
        name=name,
        parents=tuple(range(-1, nj - 1)),
        frame_names=tuple(f[0] for f in frames),
        frame_parents=tuple(f[1] for f in frames),
        joint_rot=t(np.stack([np.asarray(r, dtype=np.float64) for r in joint_rot])),
        joint_pos=t(np.stack([np.asarray(p, dtype=np.float64) for p in joint_pos])),
        axis=t(np.stack([np.asarray(a, dtype=np.float64) for a in axes])),
        mass=t(masses),
        com=t(np.stack([np.asarray(c, dtype=np.float64) for c in coms])),
        inertia=t(np.stack(inertia)),
        frame_rot=t(np.stack([np.asarray(f[2], dtype=np.float64) for f in frames])
                    if frames else np.zeros((0, 3, 3))),
        frame_pos=t(np.stack([np.asarray(f[3], dtype=np.float64) for f in frames])
                    if frames else np.zeros((0, 3))),
        gravity=t(gravity),
    )


def asr_twodof(dtype=torch.float64, device=None) -> RobotModel:
    """2-DoF planar soft arm ('asr_twodof'): joints about +z, reach 0.255 m
    along -x at q=0, EE frame at z = 0.18 with small off-axis offsets (they
    break the exact gravity equilibrium at q=0 that the VSA cold start
    would otherwise sit on)."""
    eye = np.eye(3)
    l1, l2 = 0.13, 0.125
    return make_chain(
        name="asr_twodof",
        joint_pos=[[0.0, 0.0, 0.09], [-l1, 1.0e-04, 0.05]],
        joint_rot=[eye, eye],
        axes=[[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]],
        masses=[0.3, 0.25],
        coms=[[-l1 / 2, 5.0e-04, 0.02], [-l2 / 2, 5.0e-04, 0.02]],
        inertias=[
            [1e-5, 0.3 * l1 ** 2 / 12, 0.3 * l1 ** 2 / 12],
            [1e-5, 0.25 * l2 ** 2 / 12, 0.25 * l2 ** 2 / 12],
        ],
        frames=[("EE", 1, np.eye(3), [-l2, 1.03063311e-04, 0.04])],
        dtype=dtype,
        device=device,
    )


def double_pendulum(dtype=torch.float64, device=None) -> RobotModel:
    """2-DoF pendulum ('double_pendulum'): planar in x-z, joints about +y;
    q=0 points up (+z), so the reference's initial state ``x0 = [3.14, 0,
    ...]`` (``examples/double_pendulum.py:52``) hangs down. A "tip" frame
    at the end of the second link; default gravity [0, 0, -9.81]."""
    eye = np.eye(3)
    l1, l2 = 0.2, 0.2
    m1, m2 = 0.3, 0.3
    return make_chain(
        name="double_pendulum",
        joint_pos=[[0.0, 0.0, 0.1], [0.0, 0.0, l1]],
        joint_rot=[eye, eye],
        axes=[[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]],
        masses=[m1, m2],
        coms=[[0.0, 0.0, l1 / 2], [0.0, 0.0, l2 / 2]],
        inertias=[
            [m1 * l1 ** 2 / 12, m1 * l1 ** 2 / 12, 1e-5],
            [m2 * l2 ** 2 / 12, m2 * l2 ** 2 / 12, 1e-5],
        ],
        frames=[("tip", 1, eye, [0.0, 0.0, l2])],
        dtype=dtype,
        device=device,
    )


def seven_dof_arm(dtype=torch.float64, device=None) -> RobotModel:
    """7-DoF serial arm with mixed axes and offsets ('seven_dof_arm', the
    JAX package's stand-in for the reference's ``talos_arm``): a deeper
    chain with non-planar axes, the robot of the 7-DoF SEA reach."""
    eye = np.eye(3)
    return make_chain(
        name="seven_dof_arm",
        joint_pos=[[0.0, 0.0, 0.15], [0.02, 0.0, 0.1], [0.0, 0.02, 0.12], [0.1, 0.0, 0.02],
                   [0.0, 0.0, 0.12], [0.08, 0.01, 0.0], [0.0, 0.0, 0.08]],
        joint_rot=[eye, _rot_x(0.1), eye, _rot_y(-0.15), eye, _rot_x(0.05), eye],
        axes=[[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
        masses=[2.0, 1.5, 1.2, 1.0, 0.8, 0.5, 0.3],
        coms=[[0.0, 0.01, 0.06], [0.03, 0.0, 0.05], [0.0, 0.01, 0.06], [0.05, 0.0, 0.01],
              [0.0, 0.0, 0.06], [0.04, 0.0, 0.0], [0.0, 0.0, 0.04]],
        inertias=[[8e-3, 8e-3, 3e-3], [6e-3, 6e-3, 2e-3], [5e-3, 5e-3, 2e-3],
                  [4e-3, 4e-3, 1.5e-3], [3e-3, 3e-3, 1e-3], [1.5e-3, 1.5e-3, 6e-4],
                  [8e-4, 8e-4, 4e-4]],
        frames=[("gripper", 6, np.eye(3), [0.0, 0.0, 0.08])],
        dtype=dtype,
        device=device,
    )


_REGISTRY = {
    "asr_twodof": asr_twodof,
    "double_pendulum": double_pendulum,
    "seven_dof_arm": seven_dof_arm,
}


def load(name: str, dtype=torch.float64, device=None) -> RobotModel:
    """Load a named robot (the reference's ``example_robot_data.load``)."""
    try:
        return _REGISTRY[name](dtype=dtype, device=device)
    except KeyError:
        raise KeyError(f"unknown robot '{name}'; available: {sorted(_REGISTRY)}") from None
