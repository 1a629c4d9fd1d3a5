"""Actuation maps of the soft arms: motor inputs -> torques on the soft
state ``[link (nl); motor (nl)]``.

PyTorch counterpart of ``aslr_to_tpu/models/actuation.py``
(``ASRActuation``, ``VSAASRActuation``, ``ActuationModelDoublePendulum``):
the motor torques drive the motor side, ``tau = [0; u[:nl]]``; for the VSA
the stiffness half of the control is handled inside the dynamics; the
underactuated pendulum's selection matrix drives one motor. Every map is
linear and state-independent, so ``calc_diff`` is the constant ``dtau_du
[2 nl, nu]``.
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


@dataclasses.dataclass(frozen=True)
class ActuationModelDoublePendulum:
    """Selection-matrix actuation of the underactuated pendulum, ``tau = S
    u`` (reference ``python/aslr_to/__init__.py:262-290``): ``act_link ==
    1`` drives the last motor-side joint with the last control, any other
    value the first motor-side joint (``S[nv // 2, 0]``) with the first."""

    state: StateASR
    act_link: int
    nu_: int = 2

    @property
    def nu(self) -> int:
        return self.nu_

    def _S(self, dtype, device):
        nv = self.state.nv
        S = torch.zeros((nv, self.nu_), dtype=dtype, device=device)
        if self.act_link == 1:
            S[-1, -1] = 1.0
        else:
            S[nv // 2, 0] = 1.0
        return S

    def calc(self, x_m, u):
        # S u as a broadcast product and sum: no matmul, so no TF32 on the card
        return (self._S(u.dtype, u.device) * u[..., None, :]).sum(-1)

    def calc_diff(self, x_m, u):
        """S ``[nv, nu]`` in ``u``'s dtype and device (``x_m`` may be None)."""
        return self._S(u.dtype, u.device)
