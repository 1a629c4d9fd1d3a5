"""Actuation map of the VSA arm.

PyTorch counterpart of ``aslr_to_tpu/models/actuation.py``
(``VSAASRActuation``): the motor-torque half of the control drives the
motor side, ``tau = [0; u[:nl]]``; the stiffness half is handled inside
the VSA dynamics.
"""
from __future__ import annotations

import dataclasses

import torch

from .state import StateASR


@dataclasses.dataclass(frozen=True)
class VSAASRActuation:
    state: StateASR

    @property
    def nu(self) -> int:
        return self.state.nl

    def calc(self, x_m, u):
        nl = self.state.nl
        return torch.cat([torch.zeros_like(u[..., :nl]), u[..., :nl]], dim=-1)
