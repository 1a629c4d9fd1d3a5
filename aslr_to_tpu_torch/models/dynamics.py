"""Soft-actuation forward dynamics: series-elastic (SEA) and variable
stiffness (VSA).

PyTorch counterpart of ``aslr_to_tpu/models/dynamics.py``
(``DifferentialSEADynamics`` and ``DifferentialVSADynamics``: ``calc`` and
``quasi_static``; the lane solver takes its derivatives from the
linearization kernel). With the spring torque ``tau_c = K (q_l - q_m)``:

    a_l = M(q_l)^-1 (tau_link - nle - tau_c)
    a_m = B^-1      (tau_motor + tau_c)

SEA: ``K`` is a constant matrix and ``u`` the motor torques (through the
actuation map). VSA: ``u = [tau_m (nl); k (nl)]``, ``K = diag(k)``, and the
link side receives no motor torque.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops import rigid_body as rbd
from .costs import CostModelSum, KinData
from .state import StateASR


class DiffData(NamedTuple):
    xout: torch.Tensor   # accelerations [..., state.nv]
    cost: torch.Tensor   # [...]
    kin: KinData


def _gravity_torques(state, x):
    q_l = state.split(x)[0]
    zeros = torch.zeros_like(q_l)
    return rbd.rnea(state.robot, q_l, zeros, zeros)


def _eye(state, scale):
    g = state.robot.gravity
    return scale * torch.eye(state.nl, dtype=g.dtype, device=g.device)


@dataclasses.dataclass(frozen=True)
class DifferentialSEADynamics:
    state: StateASR
    actuation: object
    costs: CostModelSum
    K: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.K is None:
            object.__setattr__(self, "K", _eye(self.state, 1e-1))
        if self.B is None:
            object.__setattr__(self, "B", _eye(self.state, 1e-3))

    @property
    def nu(self) -> int:
        return self.actuation.nu

    def calc(self, x, u) -> DiffData:
        nl = self.state.nl
        q_l, q_m, v_l, v_m = self.state.split(x)
        tau = self.actuation.calc(torch.cat([q_m, v_m], dim=-1), u)
        tau_couple = (q_l - q_m) @ self.K.transpose(-1, -2)

        M, nle = rbd.compute_all_terms(self.state.robot, q_l, v_l)
        a_l = torch.linalg.solve(M, tau[..., :nl] - nle - tau_couple)
        rhs_m = tau[..., nl:] + tau_couple
        a_m = torch.linalg.solve(self.B.expand(rhs_m.shape[:-1] + self.B.shape), rhs_m)
        xout = torch.cat([a_l, a_m], dim=-1)

        rots, trans = rbd.forward_kinematics(self.state.robot, q_l)
        kin = KinData(rots=rots, trans=trans)
        return DiffData(xout=xout, cost=self.costs.calc(x, u, kin), kin=kin)

    def quasi_static(self, x):
        """Gravity-compensation warm start: the least-squares motor input
        through the motor-side actuation block that lets the spring carry
        the gravity torque at ``q_l`` (the JAX package's reading of the
        reference's quasiStatic)."""
        nl = self.state.nl
        tau_g = _gravity_torques(self.state, x)
        u0 = torch.zeros(self.nu, dtype=x.dtype, device=x.device)
        dtau_du = self.actuation.calc_diff(None, u0)
        return tau_g @ torch.linalg.pinv(dtau_du[nl:, :]).transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class DifferentialVSADynamics:
    state: StateASR
    actuation: object
    costs: CostModelSum
    B: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.B is None:
            object.__setattr__(self, "B", _eye(self.state, 1e-3))

    @property
    def nu(self) -> int:
        return 2 * self.actuation.nu

    def calc(self, x, u) -> DiffData:
        nl = self.state.nl
        q_l, q_m, v_l, v_m = self.state.split(x)
        k_diag = u[..., nl:]
        tau_m = u[..., :nl]
        tau_couple = k_diag * (q_l - q_m)

        M, nle = rbd.compute_all_terms(self.state.robot, q_l, v_l)
        a_l = torch.linalg.solve(M, -nle - tau_couple)
        rhs_m = tau_m + tau_couple
        a_m = torch.linalg.solve(self.B.expand(rhs_m.shape[:-1] + self.B.shape), rhs_m)
        xout = torch.cat([a_l, a_m], dim=-1)

        rots, trans = rbd.forward_kinematics(self.state.robot, q_l)
        kin = KinData(rots=rots, trans=trans)
        return DiffData(xout=xout, cost=self.costs.calc(x, u, kin), kin=kin)

    def quasi_static(self, x):
        """Gravity-compensation warm start: the motor torques take the
        gravity torque, the stiffness command is zero."""
        tau_g = _gravity_torques(self.state, x)
        return torch.cat([tau_g, torch.zeros_like(tau_g)], dim=-1)
