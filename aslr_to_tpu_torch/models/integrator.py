"""Semi-implicit Euler integrator: differential model -> action model.

PyTorch counterpart of ``aslr_to_tpu/models/integrator.py``
(``IntegratedActionEuler``, ``calc`` and ``quasi_static``):
``dx = [v dt + a dt^2, a dt]``, ``xnext = x + dx``. ``dt = 0`` is the
terminal model. The cost is the differential cost, not scaled by dt.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class ActionData(NamedTuple):
    xnext: torch.Tensor
    cost: torch.Tensor


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

    def calc(self, x, u) -> ActionData:
        data = self.differential.calc(x, u)
        if self.dt == 0.0:
            return ActionData(xnext=x, cost=data.cost)
        nq = self.state.nq
        dt = self.dt
        acc = data.xout
        dx = torch.cat([x[..., nq:] * dt + acc * dt * dt, acc * dt], dim=-1)
        return ActionData(xnext=self.state.integrate(x, dx), cost=data.cost)

    def quasi_static(self, x):
        return self.differential.quasi_static(x)
