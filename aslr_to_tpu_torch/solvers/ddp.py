"""Solver types of the DDP family: settings, bounds, results.

PyTorch counterpart of the types of ``aslr_to_tpu/solvers/ddp.py``, with
the same defaults (Crocoddyl's thresholds). The batched BoxDDP loop that
consumes them is ``kernels/lane_solver.py``; the generic per-scenario
``solve`` comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class Bounds(NamedTuple):
    """Control bounds ``lb <= u <= ub`` (``[nu]``, shared by every knot)."""

    lb: torch.Tensor
    ub: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Crocoddyl-default thresholds; see ``aslr_to_tpu/solvers/ddp.py`` for
    the rationale of each knob."""

    maxiter: int = 100
    th_stop: float = 1e-9        # on sum ||Qu||^2
    th_grad: float = 1e-12
    th_gaptol: float = 1e-9
    th_acceptstep: float = 0.1
    th_acceptnegstep: float = 2.0
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_factor: float = 10.0
    n_alphas: int = 10
    boxqp_iters: int = 6
    boxqp_alphas: int = 5
    # > 0: warm-start each knot's BoxQP from the previous iteration's du and
    # run this many QP iterations instead of boxqp_iters (0 = off)
    boxqp_warm_iters: int = 0
    # max in-iteration backward retries (reg x reg_factor bumps)
    bw_retry_cap: int = 3
    # early retirement of doomed scenarios (0 = off)
    doomed_reject_iters: int = 0
    # reg factor after a rejection of the whole alpha ladder
    reg_reject_factor: float = 10.0


class SolveLog(NamedTuple):
    """Per-iteration series (``[B, maxiter]``; empty ``[B, 0]`` when off)."""

    costs: torch.Tensor
    stops: torch.Tensor
    regs: torch.Tensor
    steps: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    gap_norms: torch.Tensor


class SolveResult(NamedTuple):
    xs: torch.Tensor           # [B, T+1, nx]
    us: torch.Tensor           # [B, T, nu]
    cost: torch.Tensor         # [B]
    stop: torch.Tensor         # [B]
    iterations: torch.Tensor   # [B] int32
    converged: torch.Tensor    # [B] bool
    diverged: torch.Tensor     # [B] bool
    reg: torch.Tensor          # [B]
    log: SolveLog
