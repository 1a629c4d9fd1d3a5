"""Variable-stiffness actuation (VSA) forward dynamics.

PyTorch counterpart of ``aslr_to_tpu/models/dynamics.py``
(``DifferentialVSADynamics``, ``calc`` only). The control is
``u = [tau_m (nl); k (nl)]`` with the spring ``K = diag(k)``:

    a_l = M(q_l)^-1 (-nle - K (q_l - q_m))
    a_m = B^-1      (tau_m + K (q_l - q_m))
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


@dataclasses.dataclass(frozen=True)
class DifferentialVSADynamics:
    state: StateASR
    actuation: object
    costs: CostModelSum
    B: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.B is None:
            g = self.state.robot.gravity
            object.__setattr__(self, "B", 1e-3 * torch.eye(
                self.state.nl, dtype=g.dtype, device=g.device))

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
