"""Terminal-weight homotopy: the continuation for cold-started solves.

PyTorch counterpart of ``aslr_to_tpu/solvers/homotopy.py``. The VSA reach
(``two_dof_vsa_boxddp``, cold start, an explicit-Euler-unstable arm) stalls
in a poor local solution under plain BoxDDP. Ramping the terminal goal
weight geometrically, each stage warm-started from the last, and capping
the stiffness channels inside the stability region in the early stages,
lands it in the basin of the staged answer. ``settings.maxiter`` is the
budget of one stage.

The stages are a Python loop over ``solve`` (the batch of scenarios of
``problem.x0 [B, nx]`` at once); the lane route's counterpart, with the
diverged-lane rescue, is ``kernels/lane_solver.py::build_lane_homotopy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .ddp import Bounds, SolveResult, SolverSettings, solve
from .problem import ShootingProblem

DEFAULT_SCALES = (1e-3, 1e-2, 1e-1, 1.0)
RESCUE_SCALES = (1e-4, 1e-3, 1e-2, 5e-2, 2e-1, 1.0, 1.0)


def scale_terminal_costs(problem: ShootingProblem, scale) -> ShootingProblem:
    """``problem`` with every terminal cost weight times ``scale`` (a float
    or a 0-d tensor; with a tensor the weights become tensors of its dtype
    and device)."""
    term = problem.terminal
    costs = term.differential.costs
    items = tuple(dataclasses.replace(it, weight=it.weight * scale) for it in costs.items)
    return dataclasses.replace(
        problem,
        terminal=dataclasses.replace(
            term,
            differential=dataclasses.replace(
                term.differential,
                costs=dataclasses.replace(costs, items=items))))


def _capped(problem, bounds, plain_scales, scales, k_cap):
    """``(scales, ub_stages)``: every stage but the last caps the stiffness
    channels (the second half of the controls) at ``k_cap``; the last
    releases the full box. ``(plain_scales, None)`` for an unbounded or
    non-VSA problem."""
    from ..models.dynamics import DifferentialVSADynamics

    if bounds is None or not isinstance(problem.running.differential, DifferentialVSADynamics):
        return tuple(plain_scales), None
    ub = bounds.ub
    nk = problem.nu // 2
    cap = torch.minimum(ub, torch.cat([
        torch.full((nk,), float("inf"), dtype=ub.dtype, device=ub.device),
        torch.full((nk,), k_cap, dtype=ub.dtype, device=ub.device)]))
    return tuple(scales), torch.stack([cap] * (len(scales) - 1) + [ub])


def stiffness_continuation(problem: ShootingProblem, bounds: Optional[Bounds],
                           k_cap: float = 3.0):
    """``(scales, ub_stages)`` of the VSA stiffness-bound continuation:
    ``DEFAULT_SCALES`` with the stiffness channels capped at ``k_cap``, then
    a fifth stage at the full box (``ub_stages [5, nu]`` on the bounds'
    device and dtype). ``(DEFAULT_SCALES, None)`` unchanged when the
    problem is not a bounded VSA one."""
    return _capped(problem, bounds, DEFAULT_SCALES, tuple(DEFAULT_SCALES) + (1.0,), k_cap)


def rescue_continuation(problem: ShootingProblem, bounds: Optional[Bounds],
                        k_cap: float = 1.0):
    """``(scales, ub_stages)`` of the diverged-lane rescue: a gentler
    7-stage ramp (``RESCUE_SCALES``) under a harder stiffness cap, the full
    box released in the last stage only. ``(RESCUE_SCALES, None)`` for an
    unbounded or non-VSA problem."""
    return _capped(problem, bounds, RESCUE_SCALES, RESCUE_SCALES, k_cap)


def stage_arrays(scales, ub_stages, dtype, device):
    """The stages' scales ``[n]`` and upper bounds ``[n, nu]`` (or None) as
    tensors of the solve's dtype on its device; raises unless there is one
    row of bounds a scale."""
    scale_arr = (scales.to(dtype=dtype, device=device) if isinstance(scales, torch.Tensor)
                 else torch.tensor([float(s) for s in scales], dtype=dtype, device=device))
    ub_arr = None if ub_stages is None else torch.as_tensor(ub_stages, dtype=dtype,
                                                            device=device)
    if ub_arr is not None and ub_arr.shape[0] != scale_arr.shape[0]:
        raise ValueError("ub_stages must have one row per scale")
    return scale_arr, ub_arr


def homotopy_solve(
    problem: ShootingProblem,
    xs_init=None,
    us_init=None,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = False,
    bounds: Optional[Bounds] = None,
    fast=None,
    scales: Sequence[float] = DEFAULT_SCALES,
    ub_stages=None,
) -> SolveResult:
    """For each scale in ``scales`` (ascending, ending at 1.0), solve with
    the terminal costs scaled, warm-started from the previous stage; return
    the last stage's :class:`SolveResult`. ``ub_stages [n_stages, nu]``
    sets a stage's control upper bound (needs ``bounds``). ``fast`` (the
    fused kernels) solves each stage at that stage's terminal weight; it
    takes no per-stage box (use the lane route,
    ``make_batched_solver(..., use_fast_path="lanes")``)."""
    if ub_stages is not None:
        if bounds is None:
            raise ValueError("ub_stages requires bounds")
        if fast is not None:
            raise ValueError("ub_stages is not threaded through the fast path; use the "
                             "lane route (build_lane_homotopy) or the generic route")
    scale_arr, ub_arr = stage_arrays(scales, ub_stages, problem.x0.dtype, problem.x0.device)
    xs, us = xs_init, us_init
    res = None
    for i in range(scale_arr.shape[0]):
        p = scale_terminal_costs(problem, scale_arr[i])
        b = bounds if ub_arr is None else Bounds(lb=bounds.lb, ub=ub_arr[i])
        res = solve(p, xs, us, settings=settings, use_gaps=use_gaps, bounds=b, fast=fast)
        xs, us = res.xs, res.us
    return res
