"""Batched solving: the throughput axis of the port.

PyTorch counterpart of ``aslr_to_tpu/parallel/batch.py`` for the lane
path (``make_batched_solver(..., use_fast_path="lanes")``) and
``convergence_summary``. Sharding over several cards comes later.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..solvers.ddp import Bounds, SolveResult, SolverSettings
from ..solvers.problem import ShootingProblem


def make_batched_solver(
    problem: ShootingProblem,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = True,
    bounds: Optional[Bounds] = None,
    warm_start: bool = False,
    keep_log: bool = False,
    use_fast_path="lanes",
    globalization: Optional[str] = None,
    backend: str = "auto",
):
    """Build ``solve_batch(x0s) -> SolveResult`` over initial states
    ``x0s [B, nx]``; every other problem leaf is shared, and the solve runs
    on the problem's device. Only the lane solver (``use_fast_path="lanes"``)
    exists in the port so far. ``warm_start`` starts each scenario from the
    problem's quasi-static controls at its x0 (the reference's
    ``problem.quasiStatic``)."""
    if use_fast_path != "lanes":
        raise NotImplementedError("the port runs the lane solver only "
                                  "(use_fast_path='lanes'); the generic path comes later")
    if globalization is not None:
        raise NotImplementedError("globalization='homotopy' comes with the homotopy slice")
    from ..kernels.lane_solver import build_lane_solver, check_device

    lane = build_lane_solver(problem, settings, bounds, use_gaps=use_gaps,
                             keep_log=keep_log, backend=backend)
    if not warm_start:
        return lane

    def solve_warm(x0s):
        check_device(problem.x0.device, x0s=x0s)
        xs0 = x0s[:, None, :].expand(x0s.shape[0], problem.T + 1, x0s.shape[1])
        return lane(x0s, xs0, problem.quasi_static(xs0[:, :-1]))

    return solve_warm


def convergence_summary(result: SolveResult):
    """Cross-scenario metrics (host-side): converged fraction, mean
    iterations, cost statistics."""
    cost = result.cost.double()
    return dict(
        n=int(result.cost.shape[0]),
        converged_frac=float(result.converged.float().mean()),
        diverged_frac=float(result.diverged.float().mean()),
        mean_iterations=float(result.iterations.float().mean()),
        median_cost=float(torch.quantile(cost, 0.5)),
        p90_cost=float(torch.quantile(cost, 0.9)),
        max_cost=float(cost.max()),
    )
