"""Shooting problem: T running knots sharing one action model, plus a
terminal model.

PyTorch counterpart of ``aslr_to_tpu/solvers/problem.py`` (shared-model
problems; per-knot models come with a later slice).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShootingProblem:
    x0: torch.Tensor
    running: object
    terminal: object
    T: int

    @property
    def state(self):
        return self.running.state

    @property
    def nu(self) -> int:
        return self.running.nu

    def quasi_static(self, xs):
        """Warm-start controls ``[..., T, nu]`` for states ``[..., T, nx]``
        (the reference's ``problem.quasiStatic([x0] * T)``)."""
        return self.running.quasi_static(xs)

    def rollout(self, us, x0=None):
        """Nonlinear rollout of controls ``[..., T, nu]`` -> xs ``[..., T+1, nx]``."""
        x = self.x0 if x0 is None else x0
        x = x.expand(us.shape[:-2] + x.shape[-1:])
        xs = [x]
        for t in range(self.T):
            x = self.running.calc(x, us[..., t, :]).xnext
            xs.append(x)
        return torch.stack(xs, dim=-2)

    def calc_cost(self, xs, us):
        """Total trajectory cost of ``xs [..., T+1, nx]``, ``us [..., T, nu]``."""
        run = self.running.calc(xs[..., :-1, :], us).cost
        u0 = torch.zeros(us.shape[:-2] + (self.terminal.nu,), dtype=xs.dtype, device=xs.device)
        return run.sum(-1) + self.terminal.calc(xs[..., -1, :], u0).cost
