"""Cost library: activations, residuals, residual costs and cost sums.

PyTorch counterpart of the classes of ``aslr_to_tpu/models/costs.py`` that
the VSA and SEA presets build, with ``calc`` and ``calc_diff``. Derivatives
follow Crocoddyl's Gauss-Newton convention (``Lxx = Rx' Arr Rx``). Every
method batches over the leading dims of ``x [..., nx]`` and ``u [..., nu]``;
a residual Jacobian is ``[..., nr, ndx]``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import rigid_body as rbd
from ..ops.se3 import SE3, jlog6, log6
from .state import StateASR


class KinData(NamedTuple):
    """Forward kinematics of the link side, shared by dynamics and costs."""

    rots: torch.Tensor    # [..., nj, 3, 3]
    trans: torch.Tensor   # [..., nj, 3]


class CostDerivs(NamedTuple):
    Lx: torch.Tensor      # [..., ndx]
    Lu: torch.Tensor      # [..., nu]
    Lxx: torch.Tensor     # [..., ndx, ndx]
    Lxu: torch.Tensor     # [..., ndx, nu]
    Luu: torch.Tensor     # [..., nu, nu]


def zero_derivs(ndx, nu, x):
    """Zero derivatives over the leading dims of ``x``."""
    lead = x.shape[:-1]

    def z(*shape):
        return torch.zeros(lead + shape, dtype=x.dtype, device=x.device)

    return CostDerivs(Lx=z(ndx), Lu=z(nu), Lxx=z(ndx, ndx), Lxu=z(ndx, nu), Luu=z(nu, nu))


def _zeros_jac(x, nr, n):
    return torch.zeros(x.shape[:-1] + (nr, n), dtype=x.dtype, device=x.device)


def _eye_jac(x, n):
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    return eye.expand(x.shape[:-1] + eye.shape)


@dataclasses.dataclass(frozen=True)
class ActivationModelQuad:
    """a(r) = 0.5 ||r||^2."""

    def calc(self, r):
        return 0.5 * (r * r).sum(-1)

    def calc_diff(self, r):
        return r, torch.ones_like(r)


@dataclasses.dataclass(frozen=True)
class ActivationModelWeightedQuad:
    """a(r) = 0.5 r' diag(w) r."""

    weights: torch.Tensor

    def calc(self, r):
        return 0.5 * (r * (self.weights * r)).sum(-1)

    def calc_diff(self, r):
        return self.weights * r, self.weights.expand_as(r)


@dataclasses.dataclass(frozen=True)
class ResidualModelState:
    """r = diff(xref, x)."""

    state: StateASR
    xref: torch.Tensor
    nu: int

    def calc(self, x, u, kin):
        return self.state.diff(self.xref, x)

    def calc_diff(self, x, u, kin):
        ndx = self.state.ndx
        return _eye_jac(x, ndx), _zeros_jac(x, ndx, self.nu)


@dataclasses.dataclass(frozen=True)
class ResidualModelControl:
    """r = u."""

    state: StateASR
    nu: int

    def calc(self, x, u, kin):
        return u

    def calc_diff(self, x, u, kin):
        return _zeros_jac(x, self.nu, self.state.ndx), _eye_jac(x, self.nu)


@dataclasses.dataclass(frozen=True)
class ResidualModelFramePlacementASR:
    """r = log6(target^-1 * oMf[frame]); the frame depends on q_l only, so
    only the link-configuration block of Rx is filled."""

    state: StateASR
    frame_id: int
    placement: SE3
    nu: int = 0

    def _rMf(self, kin):
        oMf = rbd.frame_placement_from_fk(self.state.robot, kin.rots, kin.trans, self.frame_id)
        return self.placement.inverse().compose(oMf)

    def calc(self, x, u, kin):
        return log6(self._rMf(kin))

    def calc_diff(self, x, u, kin):
        nl = self.state.nl
        J = jlog6(self._rMf(kin)) @ rbd.frame_jacobian_local_from_fk(
            self.state.robot, kin.rots, kin.trans, self.frame_id)
        Rx = torch.cat([J, _zeros_jac(x, 6, self.state.ndx - nl)], dim=-1)
        return Rx, _zeros_jac(x, 6, self.nu)


@dataclasses.dataclass(frozen=True)
class CostModelResidual:
    """cost = activation(residual(x, u)), Gauss-Newton derivatives."""

    state: StateASR
    activation: object
    residual: object

    @property
    def nu(self) -> int:
        return self.residual.nu

    def calc(self, x, u, kin):
        return self.activation.calc(self.residual.calc(x, u, kin))

    def calc_diff(self, x, u, kin) -> CostDerivs:
        r = self.residual.calc(x, u, kin)
        Rx, Ru = self.residual.calc_diff(x, u, kin)
        Ar, Arr = self.activation.calc_diff(r)
        RxT, RuT = Rx.transpose(-1, -2), Ru.transpose(-1, -2)
        ArrRx = Arr[..., :, None] * Rx
        ArrRu = Arr[..., :, None] * Ru
        return CostDerivs(
            Lx=(RxT @ Ar[..., None])[..., 0],
            Lu=(RuT @ Ar[..., None])[..., 0],
            Lxx=RxT @ ArrRx,
            Lxu=RxT @ ArrRu,
            Luu=RuT @ ArrRu,
        )


@dataclasses.dataclass(frozen=True)
class CostModelStiffness:
    """Linear cost on the stiffness half of the VSA control,
    ``cost = sum(lamda (K - Kref))``, ``Lu[nu/2:] = lamda``."""

    state: StateASR
    nu: int
    lamda: torch.Tensor = 1.0
    Kref: Optional[torch.Tensor] = None

    def calc(self, x, u, kin):
        K = u[..., self.nu // 2:]
        Kref = torch.zeros_like(K) if self.Kref is None else self.Kref
        return (self.lamda * (K - Kref)).sum(-1)

    def calc_diff(self, x, u, kin) -> CostDerivs:
        d = zero_derivs(self.state.ndx, self.nu, x)
        half = self.nu // 2
        lam = torch.as_tensor(self.lamda, dtype=x.dtype, device=x.device)
        Lu = torch.cat([d.Lu[..., :half], (lam * torch.ones_like(d.Lu[..., half:]))], dim=-1)
        return d._replace(Lu=Lu)


@dataclasses.dataclass(frozen=True)
class CostItem:
    name: str
    cost: object
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class CostModelSum:
    """Weighted sum of cost models."""

    state: StateASR
    nu: int
    items: Tuple[CostItem, ...] = ()

    def add_cost(self, name, cost, weight) -> "CostModelSum":
        return dataclasses.replace(
            self, items=self.items + (CostItem(name=name, cost=cost, weight=weight),))

    def calc(self, x, u, kin):
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for it in self.items:
            total = total + it.weight * it.cost.calc(x, u, kin)
        return total

    def calc_diff(self, x, u, kin) -> CostDerivs:
        acc = zero_derivs(self.state.ndx, self.nu, x)
        for it in self.items:
            d = it.cost.calc_diff(x, u, kin)
            acc = CostDerivs(*(a + it.weight * b for a, b in zip(acc, d)))
        return acc
