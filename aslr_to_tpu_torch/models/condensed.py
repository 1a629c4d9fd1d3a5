"""Condensed soft-dynamics formulation on a rigid state.

PyTorch counterpart of ``aslr_to_tpu/models/condensed.py``: the soft
dynamics live on the rigid state ``x = [q_l, v_l]`` and the spring
coupling is a penalized residual (the formulation the reference explored
and left in its unit tests: ``unittest/actuation_test.py:12``,
``unittest/test_softdyn_residual.py:19-23``,
``unittest/test_vsa_residual.py:17-22``).

- ``ASRActuationCondensed(state, nu, B)``: the control is ``u = [tau (nv),
  q_m (nv)]`` (SEA, nu = 2 nv) or ``[tau, q_m, k]`` (VSA, nu = 3 nv); the
  link receives ``tau = u[:nv]``, the rest are decision variables of the
  feasibility residuals.
- ``SoftDynamicsResidualModel(state, nu, K, B)``: ``r = tau - K (q_m -
  q_l)``.
- ``VSADynamicsResidualModel(state, nu)``: ``r = tau - k * (q_m - q_l)``,
  ``k = u[2 nv:]``.
- ``QbActuationModel(state_asr)``: qbmove-style actuation on the soft state
  with the deflection-hardening stiffness ``K(x) = k0 + k1 (q_l - q_m)^2``
  and the derivative set the reference's test probes (``dK_dx``,
  ``dtau_dx``, ``dtau_du``, ``dK_du``, ``unittest/actuation_test.py:39-42``).

Every method batches over the leading dims of ``x`` and ``u``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .costs import _eye_jac as _eye
from .costs import _zeros_jac as _zeros
from .state import StateASR, StateMultibody


@dataclasses.dataclass(frozen=True)
class ASRActuationCondensed:
    """Condensed actuation: the link torque is a decision variable."""

    state: StateMultibody
    nu_: int
    B: Optional[torch.Tensor] = None

    @property
    def nu(self) -> int:
        return self.nu_

    def calc(self, x, u):
        return u[..., :self.state.nv]

    def calc_diff(self, x, u):
        nv = self.state.nv
        return torch.cat([_eye(u, nv), _zeros(u, nv, self.nu_ - nv)], dim=-1)


@dataclasses.dataclass(frozen=True)
class SoftDynamicsResidualModel:
    """Feasibility residual ``r = tau - K (q_m - q_l)`` (SEA, fixed K)."""

    state: StateMultibody
    nu: int
    K: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None

    @property
    def nr(self) -> int:
        return self.state.nv

    def calc(self, x, u, kin):
        nv = self.state.nv
        defl = u[..., nv:2 * nv] - x[..., :nv]
        return u[..., :nv] - defl @ self.K.transpose(-1, -2)

    def calc_diff(self, x, u, kin):
        nv = self.state.nv
        K = self.K.expand(x.shape[:-1] + self.K.shape)
        Rx = torch.cat([K, _zeros(x, nv, self.state.ndx - nv)], dim=-1)
        Ru = torch.cat([_eye(x, nv), -K, _zeros(x, nv, self.nu - 2 * nv)], dim=-1)
        return Rx, Ru


@dataclasses.dataclass(frozen=True)
class VSADynamicsResidualModel:
    """Feasibility residual ``r = tau - k * (q_m - q_l)`` (VSA, k in u)."""

    state: StateMultibody
    nu: int

    @property
    def nr(self) -> int:
        return self.state.nv

    def calc(self, x, u, kin):
        nv = self.state.nv
        k = u[..., 2 * nv:3 * nv]
        return u[..., :nv] - k * (u[..., nv:2 * nv] - x[..., :nv])

    def calc_diff(self, x, u, kin):
        nv = self.state.nv
        q_l, q_m, k = x[..., :nv], u[..., nv:2 * nv], u[..., 2 * nv:3 * nv]
        Rx = torch.cat([torch.diag_embed(k), _zeros(x, nv, self.state.ndx - nv)], dim=-1)
        Ru = torch.cat([_eye(x, nv), torch.diag_embed(-k), torch.diag_embed(-(q_m - q_l)),
                        _zeros(x, nv, self.nu - 3 * nv)], dim=-1)
        return Rx, Ru


class QbActuationData(NamedTuple):
    tau: torch.Tensor        # [..., 2 nl]
    K: torch.Tensor          # [..., nl]
    dtau_dx: torch.Tensor    # [..., 2 nl, ndx]
    dtau_du: torch.Tensor    # [..., 2 nl, nl]
    dK_dx: torch.Tensor      # [..., nl, ndx]
    dK_du: torch.Tensor      # [..., nl, nl]


@dataclasses.dataclass(frozen=True)
class QbActuationModel:
    """qbmove-style actuation with deflection-hardening stiffness:
    ``K_i(x) = k0 + k1 (q_l_i - q_m_i)^2``, ``tau = [K(x) * (q_m - q_l);
    u]`` (the spring drives the link side, the controls are motor torques),
    with the derivative set of the reference's test."""

    state: StateASR
    k0: float = 1.0
    k1: float = 0.5

    @property
    def nu(self) -> int:
        return self.state.nl

    def calc(self, x, u) -> QbActuationData:
        nl, ndx = self.state.nl, self.state.ndx
        q_l, q_m, _, _ = self.state.split(x)
        d = q_l - q_m
        K = self.k0 + self.k1 * d * d
        tau = torch.cat([K * (q_m - q_l), u[..., :nl]], dim=-1)
        zero = _zeros(x, nl, nl)
        # dK/dq_l = 2 k1 d, dK/dq_m = -2 k1 d
        dK_dql = torch.diag_embed(2.0 * self.k1 * d)
        dK_dx = torch.cat([dK_dql, -dK_dql, _zeros(x, nl, ndx - 2 * nl)], dim=-1)
        # tau_link = -K(d) d: d tau_link / d d = -(k0 + 3 k1 d^2)
        dtl_dd = torch.diag_embed(-(self.k0 + 3.0 * self.k1 * d * d))
        dtau_dx = torch.cat([torch.cat([dtl_dd, -dtl_dd, _zeros(x, nl, ndx - 2 * nl)], dim=-1),
                             _zeros(x, nl, ndx)], dim=-2)
        dtau_du = torch.cat([zero, _eye(x, nl)], dim=-2)
        return QbActuationData(tau=tau, K=K, dtau_dx=dtau_dx, dtau_du=dtau_du, dK_dx=dK_dx,
                               dK_du=zero)

    def calc_diff(self, x, u) -> QbActuationData:
        return self.calc(x, u)
