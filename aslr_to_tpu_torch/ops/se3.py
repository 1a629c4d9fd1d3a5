"""SE(3) primitives: placements, exp/log maps, batched over leading dims.

PyTorch counterpart of ``aslr_to_tpu/ops/se3.py``. A placement
``M = (rot, trans)`` maps local coordinates to world,
``x_w = rot @ x_l + trans``; 6-vectors are ``[linear(3); angular(3)]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from .so3 import exp3, log3, skew

_EPS = 1e-8


class SE3(NamedTuple):
    """Rigid placement: rotation ``[..., 3, 3]`` and translation ``[..., 3]``."""

    rot: torch.Tensor
    trans: torch.Tensor

    def inverse(self) -> "SE3":
        Rt = self.rot.transpose(-1, -2)
        return SE3(Rt, -(Rt @ self.trans[..., None])[..., 0])

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply ``other`` first in local coordinates)."""
        return SE3(self.rot @ other.rot,
                   (self.rot @ other.trans[..., None])[..., 0] + self.trans)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _v_matrix(w):
    """Left Jacobian V(w) of SO(3) (sanitized branches)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS * _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe_t2 * theta))
    W = skew(w)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _v_inv_matrix(w):
    """Closed-form inverse of the SO(3) left Jacobian (sanitized branches)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS * _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    sin_t = torch.sin(theta)
    denom = 2.0 * theta * sin_t
    safe_denom = torch.where(denom.abs() < 1e-12, torch.sign(denom) * 1e-12 + 1e-18, denom)
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / safe_t2 - (1.0 + torch.cos(theta)) / safe_denom)
    W = skew(w)
    return _eye3(w) - 0.5 * W + k[..., None, None] * (W @ W)


def exp6(xi) -> SE3:
    """SE(3) exponential of ``xi = [v; w]``."""
    v, w = xi[..., :3], xi[..., 3:]
    return SE3(exp3(w), (_v_matrix(w) @ v[..., None])[..., 0])


def log6(M: SE3):
    """SE(3) logarithm as a 6-vector ``[v; w]``."""
    w = log3(M.rot)
    v = (_v_inv_matrix(w) @ M.trans[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def jacfwd(f, x):
    """Jacobian ``[..., m, n]`` of ``f: [..., n] -> [..., m]``, applied to
    each element of the leading dims on its own: the counterpart of
    ``jax.jacfwd`` under ``vmap``. One forward-mode pass (dual tensors)
    over ``n`` copies of ``x``, the j-th with the j-th basis tangent; ``f``
    must broadcast over a new leading dim and not write into its input."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    xr = x.expand((n,) + x.shape).contiguous()
    tangent = eye.reshape((n,) + (1,) * (x.dim() - 1) + (n,)).expand_as(xr).contiguous()
    with fwAD.dual_level():
        y = f(fwAD.make_dual(xr, tangent))
        dy = fwAD.unpack_dual(y).tangent
    if dy is None:                      # f does not depend on x
        dy = torch.zeros_like(y)
    return dy.movedim(0, -1)


def jlog6(M: SE3):
    """Jacobian ``[..., 6, 6]`` of ``xi -> log6(M * exp6(xi))`` at ``xi = 0``
    (``pinocchio.Jlog6``), by forward mode through the closed-form maps;
    ``log3``'s sanitized branches keep the tangents finite near pi."""
    def f(xi):
        return log6(M.compose(exp6(xi)))

    zero = torch.zeros(M.trans.shape[:-1] + (6,), dtype=M.trans.dtype, device=M.trans.device)
    return jacfwd(f, zero)
