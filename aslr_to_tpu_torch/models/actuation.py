"""Actuation maps of the soft arms: motor inputs -> torques on the soft
state ``[link (nl); motor (nl)]``.

PyTorch counterpart of ``aslr_to_tpu/models/actuation.py``
(``ASRActuation``, ``VSAASRActuation``): the motor torques drive the motor
side, ``tau = [0; u[:nl]]``. For the VSA the stiffness half of the control
is handled inside the dynamics. Both maps are linear and state-independent,
so ``calc_diff`` is the constant ``dtau_du [2 nl, nl]``.
"""
from __future__ import annotations

import dataclasses

import torch

from .state import StateASR


def _motor_torques(state, u):
    nl = state.nl
    return torch.cat([torch.zeros_like(u[..., :nl]), u[..., :nl]], dim=-1)


def _dtau_du(state, u):
    eye = torch.eye(state.nl, dtype=u.dtype, device=u.device)
    return torch.cat([torch.zeros_like(eye), eye], dim=0)


@dataclasses.dataclass(frozen=True)
class ASRActuation:
    """The SEA arm's actuation: the whole control is motor torque."""

    state: StateASR

    @property
    def nu(self) -> int:
        return self.state.nl

    def calc(self, x_m, u):
        return _motor_torques(self.state, u)

    def calc_diff(self, x_m, u):
        return _dtau_du(self.state, u)


@dataclasses.dataclass(frozen=True)
class VSAASRActuation:
    """The motor-torque half of the VSA arm's control."""

    state: StateASR

    @property
    def nu(self) -> int:
        return self.state.nl

    def calc(self, x_m, u):
        return _motor_torques(self.state, u)

    def calc_diff(self, x_m, u):
        return _dtau_du(self.state, u)
