"""Soft-robot state space ``x = [q_l, q_m, v_l, v_m]``.

PyTorch counterpart of ``aslr_to_tpu/models/state.py`` (``StateASR``). The
configurations of the registry robots are Euclidean, so ``diff`` and
``integrate`` are vector subtraction and addition and their Jacobians
(``jdiff``, ``jintegrate``) are identities.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.rigid_body import RobotModel


@dataclasses.dataclass(frozen=True)
class StateASR:
    robot: RobotModel

    @property
    def nl(self) -> int:
        return self.robot.nv

    @property
    def nq(self) -> int:
        return 2 * self.robot.nq

    @property
    def nv(self) -> int:
        return 2 * self.robot.nv

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def ndx(self) -> int:
        return 2 * self.nv

    def split(self, x):
        """x -> (q_l, q_m, v_l, v_m)."""
        nl = self.nl
        return x[..., :nl], x[..., nl:2 * nl], x[..., 2 * nl:3 * nl], x[..., 3 * nl:]

    def zero(self):
        g = self.robot.gravity
        return torch.zeros(self.nx, dtype=g.dtype, device=g.device)

    def diff(self, x0, x1):
        return x1 - x0

    def integrate(self, x, dx):
        return x + dx

    def _eye(self, x):
        eye = torch.eye(self.ndx, dtype=x.dtype, device=x.device)
        return eye.expand(x.shape[:-1] + eye.shape)

    def jdiff(self, x0, x1):
        """(d diff / d x0, d diff / d x1): ``(-I, I)`` for Euclidean configurations."""
        eye = self._eye(x0)
        return -eye, eye

    def jintegrate(self, x, dx):
        """(d integrate / d x, d integrate / d dx): identities."""
        eye = self._eye(x)
        return eye, eye
