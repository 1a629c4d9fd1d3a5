"""SO(3) primitives: hat map, exponential, logarithm, batched over leading dims.

PyTorch counterpart of ``aslr_to_tpu/ops/so3.py``. Vectors are ``[..., 3]``,
matrices ``[..., 3, 3]``. Every branch of every ``torch.where`` is evaluated
on sanitized inputs (the double-``where`` pattern), so forward-mode
derivatives stay finite at theta = 0 and theta = pi.
"""
from __future__ import annotations

import math

import torch

_EPS2 = 1e-16   # theta^2 threshold for the small-angle branch (theta < 1e-8)


def skew(w):
    """Hat map: ``[..., 3] -> [..., 3, 3]`` with ``skew(w) @ v = w x v``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def unskew(W):
    """Inverse of the hat map (vee), assuming W is skew-symmetric."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp3(w):
    """Rodrigues formula: rotation matrix of the axis-angle vector ``w``."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    W = skew(w)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log3(R):
    """Axis-angle vector of a rotation matrix (``pinocchio.log3`` semantics)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    u = 1.0 - c
    s = 1.0 + c
    vee = unskew(R - R.transpose(-1, -2)) * 0.5

    small = u < 5e-10
    near_pi = s < 5e-7

    safe_c = torch.where(small | near_pi, torch.zeros_like(c), c)
    theta = torch.arccos(safe_c)
    sin_theta = torch.sin(theta)
    w_generic = vee * (theta / sin_theta)[..., None]

    theta2_t = 2.0 * u * (1.0 + u / 6.0)
    w_small = vee * (1.0 + theta2_t / 6.0)[..., None]

    theta_pi = math.pi - torch.sqrt(torch.clamp(2.0 * s, min=1e-30)) * (1.0 + s / 12.0)
    S = R + _eye3(R)
    col_norms = torch.linalg.norm(S, dim=-2)                      # [..., 3]
    k = torch.argmax(col_norms, dim=-1, keepdim=True)             # [..., 1]
    col = torch.take_along_dim(S, k[..., None, :], dim=-1)[..., 0]
    nk = torch.take_along_dim(col_norms, k, dim=-1)[..., 0]
    axis = col / torch.clamp(nk, min=1e-30)[..., None]
    flip = torch.where((axis * vee).sum(-1) < 0.0, -1.0, 1.0).to(R.dtype)
    w_pi = axis * (flip * theta_pi)[..., None]

    return torch.where(small[..., None], w_small,
                       torch.where(near_pi[..., None], w_pi, w_generic))
