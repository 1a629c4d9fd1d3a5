"""Cost library: activations, residuals, residual costs and cost sums.

PyTorch counterpart of the classes of ``aslr_to_tpu/models/costs.py`` that
the VSA preset builds. ``calc`` only: the derivatives of this slice come
from the linearization kernel (``kernels/vsa_kernels.py``). Every ``calc``
batches over the leading dims of ``x [..., nx]`` and ``u [..., nu]``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import rigid_body as rbd
from ..ops.se3 import SE3, log6
from .state import StateASR


class KinData(NamedTuple):
    """Forward kinematics of the link side, shared by dynamics and costs."""

    rots: torch.Tensor    # [..., nj, 3, 3]
    trans: torch.Tensor   # [..., nj, 3]


@dataclasses.dataclass(frozen=True)
class ActivationModelQuad:
    """a(r) = 0.5 ||r||^2."""

    def calc(self, r):
        return 0.5 * (r * r).sum(-1)


@dataclasses.dataclass(frozen=True)
class ActivationModelWeightedQuad:
    """a(r) = 0.5 r' diag(w) r."""

    weights: torch.Tensor

    def calc(self, r):
        return 0.5 * (r * (self.weights * r)).sum(-1)


@dataclasses.dataclass(frozen=True)
class ResidualModelState:
    """r = diff(xref, x)."""

    state: StateASR
    xref: torch.Tensor
    nu: int

    def calc(self, x, u, kin):
        return self.state.diff(self.xref, x)


@dataclasses.dataclass(frozen=True)
class ResidualModelControl:
    """r = u."""

    state: StateASR
    nu: int

    def calc(self, x, u, kin):
        return u


@dataclasses.dataclass(frozen=True)
class ResidualModelFramePlacementASR:
    """r = log6(target^-1 * oMf[frame])."""

    state: StateASR
    frame_id: int
    placement: SE3
    nu: int = 0

    def calc(self, x, u, kin):
        oMf = rbd.frame_placement_from_fk(self.state.robot, kin.rots, kin.trans, self.frame_id)
        return log6(self.placement.inverse().compose(oMf))


@dataclasses.dataclass(frozen=True)
class CostModelResidual:
    """cost = activation(residual(x, u))."""

    state: StateASR
    activation: object
    residual: object

    @property
    def nu(self) -> int:
        return self.residual.nu

    def calc(self, x, u, kin):
        return self.activation.calc(self.residual.calc(x, u, kin))


@dataclasses.dataclass(frozen=True)
class CostModelStiffness:
    """Linear cost on the stiffness half of the VSA control,
    ``cost = sum(lamda (K - Kref))``."""

    state: StateASR
    nu: int
    lamda: torch.Tensor = 1.0
    Kref: Optional[torch.Tensor] = None

    def calc(self, x, u, kin):
        K = u[..., self.nu // 2:]
        Kref = torch.zeros_like(K) if self.Kref is None else self.Kref
        return (self.lamda * (K - Kref)).sum(-1)


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
