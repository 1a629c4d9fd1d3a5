"""Semi-implicit Euler integrator: differential model -> action model.

PyTorch counterpart of ``aslr_to_tpu/models/integrator.py``
(``IntegratedActionEuler``: ``calc``, ``calc_diff``, ``calc_with_diff``,
``quasi_static``): ``dx = [v dt + a dt^2, a dt]``, ``xnext = x + dx``.
``dt = 0`` is the terminal model (Fx = I, Fu = 0, cost terms only). The
cost is the differential cost, not scaled by dt.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class ActionData(NamedTuple):
    xnext: torch.Tensor
    cost: torch.Tensor


class ActionDerivs(NamedTuple):
    Fx: torch.Tensor     # [..., ndx, ndx]
    Fu: torch.Tensor     # [..., ndx, nu]
    Lx: torch.Tensor     # [..., ndx]
    Lu: torch.Tensor     # [..., nu]
    Lxx: torch.Tensor    # [..., ndx, ndx]
    Lxu: torch.Tensor    # [..., ndx, nu]
    Luu: torch.Tensor    # [..., nu, nu]


@dataclasses.dataclass(frozen=True)
class IntegratedActionEuler:
    differential: object
    dt: float = 1e-3

    @property
    def state(self):
        return self.differential.state

    @property
    def nu(self) -> int:
        return self.differential.nu

    def _dx(self, x, acc):
        dt = self.dt
        return torch.cat([x[..., self.state.nq:] * dt + acc * dt * dt, acc * dt], dim=-1)

    def calc(self, x, u) -> ActionData:
        data = self.differential.calc(x, u)
        if self.dt == 0.0:
            return ActionData(xnext=x, cost=data.cost)
        return ActionData(xnext=self.state.integrate(x, self._dx(x, data.xout)), cost=data.cost)

    def calc_diff(self, x, u) -> ActionDerivs:
        return self.calc_with_diff(x, u)[1]

    def calc_with_diff(self, x, u):
        """(ActionData, ActionDerivs) sharing one dynamics evaluation: the
        chain rule through the integrator. The terminal model (dt = 0)
        needs only the cost derivatives."""
        state = self.state
        nv, ndx, dt = state.nv, state.ndx, self.dt
        data = self.differential.calc(x, u)
        if dt == 0.0:
            cd = self.differential.costs.calc_diff(x, u, data.kin)
            eye = torch.eye(ndx, dtype=x.dtype, device=x.device)
            Fu = torch.zeros(x.shape[:-1] + (ndx, self.nu), dtype=x.dtype, device=x.device)
            return (ActionData(xnext=x, cost=data.cost),
                    ActionDerivs(eye.expand(x.shape[:-1] + eye.shape), Fu, *cd))
        d = self.differential.calc_diff(x, u, data)
        dx = self._dx(x, data.xout)
        dxnext_dx, dxnext_ddx = state.jintegrate(x, dx)
        shift = torch.zeros((nv, ndx), dtype=x.dtype, device=x.device)
        shift[:, nv:2 * nv] = torch.eye(nv, dtype=x.dtype, device=x.device)
        ddx_dx = torch.cat([d.Fx * dt + shift, d.Fx], dim=-2)
        Fx = dxnext_dx + dt * (dxnext_ddx @ ddx_dx)
        ddx_du = torch.cat([d.Fu * dt, d.Fu], dim=-2)
        Fu = dt * (dxnext_ddx @ ddx_du)
        return (ActionData(xnext=state.integrate(x, dx), cost=data.cost),
                ActionDerivs(Fx, Fu, *d.costs))

    def quasi_static(self, x):
        return self.differential.quasi_static(x)
