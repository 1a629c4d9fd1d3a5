"""State spaces: the soft robot's ``x = [q_l, q_m, v_l, v_m]`` and the
rigid robot's ``x = [q, v]``.

PyTorch counterpart of ``aslr_to_tpu/models/state.py`` (``StateASR``,
``StateMultibody``). The configurations of the registry robots are
Euclidean, so ``diff`` and ``integrate`` are vector subtraction and
addition and their Jacobians (``jdiff``, ``jintegrate``) are identities.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.rigid_body import RobotModel


class _Euclidean:
    """The Lie-group API of Euclidean configurations: ``diff`` and
    ``integrate`` are vector subtraction and addition, their Jacobians
    identities."""

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
        """(d diff / d x0, d diff / d x1): ``(-I, I)``."""
        eye = self._eye(x0)
        return -eye, eye

    def jintegrate(self, x, dx):
        """(d integrate / d x, d integrate / d dx): identities."""
        eye = self._eye(x)
        return eye, eye


@dataclasses.dataclass(frozen=True)
class StateASR(_Euclidean):
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


@dataclasses.dataclass(frozen=True)
class StateMultibody(_Euclidean):
    """Rigid-robot state ``x = [q, v]`` (Crocoddyl's ``StateMultibody``)."""

    robot: RobotModel

    @property
    def nq(self) -> int:
        return self.robot.nq

    @property
    def nv(self) -> int:
        return self.robot.nv

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def ndx(self) -> int:
        return 2 * self.nv

    def split(self, x):
        """x -> (q, v)."""
        return x[..., :self.nq], x[..., self.nq:]

    def rand(self, generator: torch.Generator):
        """A state uniform in [-1, 1)^nx, drawn from ``generator`` (on the
        robot's device)."""
        g = self.robot.gravity
        u = torch.rand(self.nx, generator=generator, dtype=g.dtype, device=g.device)
        return 2.0 * u - 1.0
