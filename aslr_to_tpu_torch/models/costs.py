"""Cost library: activations, residuals, residual costs and cost sums.

PyTorch counterpart of ``aslr_to_tpu/models/costs.py``, with ``calc`` and
``calc_diff``. Derivatives follow Crocoddyl's Gauss-Newton convention
(``Lxx = Rx' Arr Rx``), except the swing-up cost
``CostModelDoublePendulum``, which keeps the reference's hand-rolled
diagonal second-order model. Every
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


class ActivationBounds(NamedTuple):
    lb: torch.Tensor
    ub: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ActivationModelQuadraticBarrier:
    """Quadratic penalty outside ``[lb, ub]`` (Crocoddyl's semantics; the
    reference's condensed soft-dynamics tests bound the spring deflection
    with it, ``unittest/test_softdyn_residual.py:24-26``)."""

    bounds: ActivationBounds

    def _parts(self, r):
        lo = torch.clamp(r - self.bounds.lb, max=0.0)
        hi = torch.clamp(r - self.bounds.ub, min=0.0)
        return lo, hi

    def calc(self, r):
        lo, hi = self._parts(r)
        return 0.5 * ((lo * lo).sum(-1) + (hi * hi).sum(-1))

    def calc_diff(self, r):
        lo, hi = self._parts(r)
        return lo + hi, ((lo < 0.0) | (hi > 0.0)).to(r.dtype)


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


def _pendulum_trig(x):
    return torch.cos(x[..., 0]), torch.cos(x[..., 1]), torch.sin(x[..., 0]), torch.sin(x[..., 1])


def _sparse_rows(x, ndx, entries):
    """A ``[..., 6, ndx]`` matrix, zero but at ``entries`` {(i, j): value}."""
    M = _zeros_jac(x, 6, ndx)
    for (i, j), v in entries.items():
        M[..., i, j] = v
    return M


@dataclasses.dataclass(frozen=True)
class ResidualModelDoublePendulum:
    """Swing-up residual ``r = [s1, s2, 1 + c1, 1 - c2, v1, v2]`` with its
    analytic Rx, the reference's sign conventions included
    (``python/aslr_to/residual_acrobot.py:5-29``: ``Rx[3, 1] = +s2``)."""

    state: StateASR
    nu: int

    def calc(self, x, u, kin):
        c1, c2, s1, s2 = _pendulum_trig(x)
        return torch.stack([s1, s2, 1.0 + c1, 1.0 - c2, x[..., 4], x[..., 5]], dim=-1)

    def calc_diff(self, x, u, kin):
        c1, c2, s1, s2 = _pendulum_trig(x)
        Rx = _sparse_rows(x, self.state.ndx, {(0, 0): c1, (1, 1): c2, (2, 0): -s1,
                                              (3, 1): s2, (4, 4): 1.0, (5, 5): 1.0})
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
class CostModelDoublePendulum:
    """The reference's self-contained swing-up cost
    (``python/aslr_to/__init__.py:223-259``): the residual ``[s1, s2, 1 +
    c1, 1 + c2, v1, v2]`` (against the residual model's ``1 - c2``), and
    the hand-rolled diagonal second-order model ``Lxx = diag(Rxx' Arr)``
    with the reference's Rxx rows, verbatim; it is negative where ``c1^2 <
    s1^2``, at the hanging start among others."""

    state: StateASR
    activation: object
    nu: int

    def _residual(self, x):
        c1, c2, s1, s2 = _pendulum_trig(x)
        return torch.stack([s1, s2, 1.0 + c1, 1.0 + c2, x[..., 4], x[..., 5]], dim=-1)

    def calc(self, x, u, kin):
        return self.activation.calc(self._residual(x))

    def calc_diff(self, x, u, kin) -> CostDerivs:
        ndx = self.state.ndx
        c1, c2, s1, s2 = _pendulum_trig(x)
        Ar, Arr = self.activation.calc_diff(self._residual(x))
        Rx = _sparse_rows(x, ndx, {(0, 0): c1, (1, 1): c2, (2, 0): -s1, (3, 1): -s2,
                                   (4, 4): 1.0, (5, 5): 1.0})
        Rxx = _sparse_rows(x, ndx, {(0, 0): c1 ** 2 - s1 ** 2, (1, 1): c2 ** 2 - s2 ** 2,
                                    (2, 0): s1 ** 2 + (1.0 - c1) * c1,
                                    (3, 1): s2 ** 2 + (1.0 - c2) * c2,
                                    (4, 4): 1.0, (5, 5): 1.0})
        d = zero_derivs(ndx, self.nu, x)
        return d._replace(Lx=(Rx.transpose(-1, -2) @ Ar[..., None])[..., 0],
                          Lxx=torch.diag_embed((Rxx.transpose(-1, -2) @ Arr[..., None])[..., 0]))


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
