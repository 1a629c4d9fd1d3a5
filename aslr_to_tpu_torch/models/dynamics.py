"""Forward dynamics: series-elastic (SEA) and variable stiffness (VSA)
actuation, and the rigid robot.

PyTorch counterpart of ``aslr_to_tpu/models/dynamics.py``
(``DifferentialSEADynamics``, ``DifferentialVSADynamics`` and
``DifferentialFreeFwdDynamics``: ``calc``, ``calc_diff`` and
``quasi_static``; the lane solver takes its derivatives from the
linearization kernel, the generic solver from ``calc_diff``). The rigid
model's accelerations are ``aba``'s, ``a = M^-1 (u - nle)``. With the
spring torque ``tau_c = K (q_l - q_m)``:

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
from .costs import CostDerivs, CostModelSum, KinData
from .state import StateASR, StateMultibody


class DiffData(NamedTuple):
    xout: torch.Tensor   # accelerations [..., state.nv]
    cost: torch.Tensor   # [...]
    kin: KinData


class DiffDerivs(NamedTuple):
    Fx: torch.Tensor     # [..., nv, ndx] acceleration Jacobian w.r.t. the state
    Fu: torch.Tensor     # [..., nv, nu]
    costs: CostDerivs


def _inv(A):
    """Batched inverse; a singular matrix gives NaN, as ``jnp.linalg.inv``
    does, instead of raising (and no host sync on the card)."""
    Ainv, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], Ainv, torch.nan)


def _solve(A, b):
    """Batched ``A x = b`` for vectors ``b``; NaN where A is singular, as
    ``jnp.linalg.solve`` gives, instead of raising."""
    x, info = torch.linalg.solve_ex(A.expand(b.shape[:-1] + A.shape[-2:]), b)
    return torch.where((info == 0)[..., None], x, torch.nan)


def _acc_jacobian(state, x, a_l, K):
    """Fx of the soft-arm accelerations for the spring matrix ``K``
    ``[..., nl, nl]``: the link rows from the RNEA partials at (q_l, v_l,
    a_l) (which include the dM/dq a terms). Returns the link rows of Fx
    and Minv; the caller adds the motor rows."""
    q_l, _, v_l, _ = state.split(x)
    dtau_dq, dtau_dv = rbd.rnea_derivatives(state.robot, q_l, v_l, a_l)
    Minv = _inv(rbd.mass_matrix(state.robot, q_l))
    zero = torch.zeros_like(Minv)
    top = torch.cat([Minv @ (-dtau_dq - K), Minv @ K, Minv @ (-dtau_dv), zero], dim=-1)
    return top, Minv


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
        a_l = _solve(M, tau[..., :nl] - nle - tau_couple)
        a_m = _solve(self.B, tau[..., nl:] + tau_couple)
        xout = torch.cat([a_l, a_m], dim=-1)

        rots, trans = rbd.forward_kinematics(self.state.robot, q_l)
        kin = KinData(rots=rots, trans=trans)
        return DiffData(xout=xout, cost=self.costs.calc(x, u, kin), kin=kin)

    def calc_diff(self, x, u, data: Optional[DiffData] = None) -> DiffDerivs:
        nl = self.state.nl
        if data is None:
            data = self.calc(x, u)
        dtau_du = self.actuation.calc_diff(None, u)
        K = self.K.expand(x.shape[:-1] + self.K.shape)
        top, Minv = _acc_jacobian(self.state, x, data.xout[..., :nl], K)
        Binv = _inv(self.B)
        BK = Binv @ K
        zero = torch.zeros_like(BK)
        Fx = torch.cat([top, torch.cat([BK, -BK, zero, zero], dim=-1)], dim=-2)
        Fu = torch.cat([Minv @ dtau_du[:nl, :], (Binv @ dtau_du[nl:, :]).expand(
            x.shape[:-1] + (nl, self.nu))], dim=-2)
        return DiffDerivs(Fx=Fx, Fu=Fu, costs=self.costs.calc_diff(x, u, data.kin))

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
        a_l = _solve(M, -nle - tau_couple)
        a_m = _solve(self.B, tau_m + tau_couple)
        xout = torch.cat([a_l, a_m], dim=-1)

        rots, trans = rbd.forward_kinematics(self.state.robot, q_l)
        kin = KinData(rots=rots, trans=trans)
        return DiffData(xout=xout, cost=self.costs.calc(x, u, kin), kin=kin)

    def calc_diff(self, x, u, data: Optional[DiffData] = None) -> DiffDerivs:
        """Fx as the SEA's with K = diag(k); the stiffness columns of Fu are
        ``Minv (q_m - q_l)`` (link) and ``Binv (q_l - q_m)`` (motor), by
        broadcast over the columns, and the torque columns ``[0; Binv]``."""
        nl = self.state.nl
        if data is None:
            data = self.calc(x, u)
        q_l, q_m, _, _ = self.state.split(x)
        K = torch.diag_embed(u[..., nl:])
        top, Minv = _acc_jacobian(self.state, x, data.xout[..., :nl], K)
        Binv = _inv(self.B)
        BK = Binv @ K
        zero = torch.zeros_like(BK)
        Fx = torch.cat([top, torch.cat([BK, -BK, zero, zero], dim=-1)], dim=-2)
        Fu = torch.cat([
            torch.cat([zero, Minv * (q_m - q_l)[..., None, :]], dim=-1),
            torch.cat([Binv.expand_as(zero), Binv * (q_l - q_m)[..., None, :]], dim=-1),
        ], dim=-2)
        return DiffDerivs(Fx=Fx, Fu=Fu, costs=self.costs.calc_diff(x, u, data.kin))

    def quasi_static(self, x):
        """Gravity-compensation warm start: the motor torques take the
        gravity torque, the stiffness command is zero."""
        tau_g = _gravity_torques(self.state, x)
        return torch.cat([tau_g, torch.zeros_like(tau_g)], dim=-1)


@dataclasses.dataclass(frozen=True)
class DifferentialFreeFwdDynamics:
    """Rigid free forward dynamics ``a = M^-1 (tau - nle)`` with ``tau = u``
    (Crocoddyl's ``DifferentialActionModelFreeFwdDynamics``, the base of the
    reference's condensed formulation,
    ``unittest/test_softdyn_residual.py:33``)."""

    state: StateMultibody
    costs: CostModelSum

    @property
    def nu(self) -> int:
        return self.state.nv

    def calc(self, x, u) -> DiffData:
        q, v = self.state.split(x)
        a = rbd.aba(self.state.robot, q, v, u)
        rots, trans = rbd.forward_kinematics(self.state.robot, q)
        kin = KinData(rots=rots, trans=trans)
        return DiffData(xout=a, cost=self.costs.calc(x, u, kin), kin=kin)

    def calc_diff(self, x, u, data: Optional[DiffData] = None) -> DiffDerivs:
        """Fx = Minv [-dtau_dq, -dtau_dv] from the RNEA partials at (q, v,
        a); Fu = Minv."""
        q, v = self.state.split(x)
        if data is None:
            data = self.calc(x, u)
        dtau_dq, dtau_dv = rbd.rnea_derivatives(self.state.robot, q, v, data.xout)
        Minv = _inv(rbd.mass_matrix(self.state.robot, q))
        Fx = torch.cat([Minv @ (-dtau_dq), Minv @ (-dtau_dv)], dim=-1)
        return DiffDerivs(Fx=Fx, Fu=Minv, costs=self.costs.calc_diff(x, u, data.kin))

    def quasi_static(self, x):
        """The gravity torques at q: RNEA at zero velocity and acceleration."""
        q = self.state.split(x)[0]
        zeros = torch.zeros_like(q)
        return rbd.rnea(self.state.robot, q, zeros, zeros)
