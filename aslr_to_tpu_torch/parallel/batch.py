"""Batched solving: the throughput axis of the port.

PyTorch counterpart of ``aslr_to_tpu/parallel/batch.py``:
``make_batched_solver`` (the generic per-scenario solver, its fused fast
path, and the lane solver, each also with the terminal-weight homotopy)
and ``convergence_summary``. Sharding over several cards comes later.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.lane_solver import build_lane_homotopy, build_lane_solver, check_device
from ..kernels.vsa_kernels import build_fast_path
from ..solvers.ddp import Bounds, SolveLog, SolveResult, SolverSettings, solve
from ..solvers.homotopy import DEFAULT_SCALES, homotopy_solve
from ..solvers.problem import ShootingProblem


def make_batched_solver(
    problem: ShootingProblem,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = True,
    bounds: Optional[Bounds] = None,
    warm_start: bool = False,
    keep_log: bool = False,
    use_fast_path=False,
    globalization: Optional[str] = None,
    scales=None,
    ub_stages=None,
    rescue_scales=None,
    rescue_ub_stages=None,
    rescue_size: int = 0,
    backend: str = "auto",
):
    """Build ``solve_batch(x0s) -> SolveResult`` over initial states
    ``x0s [B, nx]``; every other problem leaf is shared by the scenarios,
    and the solve runs on the problem's device. A per-knot problem
    (``stack_knots``, ``per_knot=True``) and a ``[T, nu]`` box run on every
    route: the kernel routes take a moving frame target and a box a knot as
    tables (``kernels/vsa_kernels.py::extract_vsa_spec`` raises
    ``TypeError`` naming any other leaf that varies; the generic route
    solves it). ``use_fast_path``: ``False`` runs the generic
    per-scenario solver (``solvers/ddp.py::solve``, the reference);
    ``True`` its fused route (K1 linearize, K6 rollout, and the Riccati
    kernels, ``use_pallas_backward`` forced on, as the JAX package does);
    ``"lanes"`` the lane solver (``kernels/lane_solver.py``).
    ``warm_start`` starts each scenario from the problem's quasi-static
    controls at its x0 (the reference's ``problem.quasiStatic``).
    ``keep_log`` keeps the per-iteration ``SolveLog`` series on every
    route. ``backend="plain"`` runs the lane and fast routes'
    kernels as their plain versions on any device (the generic route's
    Riccati kernels, under ``use_pallas_backward``, follow the device).

    ``globalization="homotopy"`` runs the terminal-weight continuation
    (``solvers/homotopy.py``; ``scales``, default ``DEFAULT_SCALES``, and
    ``ub_stages``, a stage's control upper bound, as from
    ``stiffness_continuation``), ``settings.maxiter`` a stage's budget: on
    the lane route ``build_lane_homotopy``, with the diverged-lane rescue
    when ``rescue_size`` > 0 (``rescue_scales``, ``rescue_ub_stages``, as
    from ``rescue_continuation``); on the fast route ``homotopy_solve``
    with the fused kernels (scales only); on the generic route
    ``homotopy_solve`` on the batched problem."""
    if globalization not in (None, "homotopy"):
        raise ValueError(f"globalization must be None or 'homotopy', got {globalization!r}")
    homotopy = globalization == "homotopy"
    if rescue_size and not (homotopy and use_fast_path == "lanes"):
        raise ValueError("the diverged-lane rescue runs on the lane route's homotopy only")
    if use_fast_path == "lanes":
        if homotopy:
            lane = build_lane_homotopy(problem, settings, bounds, use_gaps=use_gaps,
                                       scales=scales, ub_stages=ub_stages, keep_log=keep_log,
                                       rescue_scales=rescue_scales,
                                       rescue_ub_stages=rescue_ub_stages,
                                       rescue_size=rescue_size, backend=backend)
        else:
            lane = build_lane_solver(problem, settings, bounds, use_gaps=use_gaps,
                                     keep_log=keep_log, backend=backend)
        if not warm_start:
            return lane

        def solve_warm(x0s):
            check_device(problem.x0.device, x0s=x0s)
            xs0 = x0s[:, None, :].expand(x0s.shape[0], problem.T + 1, x0s.shape[1])
            return lane(x0s, xs0, problem.quasi_static(xs0[:, :-1]))

        return solve_warm
    if use_fast_path not in (False, True):
        raise ValueError(f"use_fast_path must be False, True or 'lanes', got {use_fast_path!r}")

    fast = None
    if use_fast_path:
        fast = build_fast_path(problem, bounds, use_gaps=use_gaps, backend=backend)
        # the fused linearize and rollout and the fused backward belong together
        settings = dataclasses.replace(settings, use_pallas_backward=True)

    def solve_batch(x0s):
        check_device(problem.x0.device, x0s=x0s)
        p = dataclasses.replace(problem, x0=x0s)
        us0 = None
        if warm_start:
            xs0 = x0s[:, None, :].expand(x0s.shape[0], problem.T + 1, x0s.shape[1])
            us0 = problem.quasi_static(xs0[:, :-1])
        if homotopy:
            res = homotopy_solve(p, None, us0, settings=settings, use_gaps=use_gaps,
                                 bounds=bounds, fast=fast, scales=scales or DEFAULT_SCALES,
                                 ub_stages=ub_stages)
        else:
            res = solve(p, None, us0, settings=settings, use_gaps=use_gaps, bounds=bounds,
                        fast=fast)
        if not keep_log:
            empty = torch.zeros((x0s.shape[0], 0), dtype=res.cost.dtype, device=x0s.device)
            res = res._replace(log=SolveLog(*[empty for _ in SolveLog._fields]))
        return res

    return solve_batch


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
