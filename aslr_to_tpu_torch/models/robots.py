"""Robot models: serial-chain builder and the 2-DoF soft arm.

PyTorch counterpart of ``aslr_to_tpu/models/robots.py`` (``make_chain`` and
``asr_twodof``; the other robots come with later slices).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rigid_body import RobotModel


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
