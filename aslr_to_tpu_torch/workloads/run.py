"""Workload runner: solve a preset and report the reference's metrics
(final end-effector placement, control effort, the convergence trace).

PyTorch counterpart of ``aslr_to_tpu/workloads/run.py``, which replaces
the reference example scripts' solve-and-print logic
(``examples/two_dof_sea.py:78-93``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import rigid_body as rbd
from ..solvers.ddp import SolveLog, SolveResult, SolverSettings
from ..utils.metrics import u_squared
from .presets import PRESETS, Workload


class WorkloadResult(NamedTuple):
    result: SolveResult
    ee_final: torch.Tensor    # final end-effector translation (zeros without a frame)
    u_sq: torch.Tensor        # per-channel control effort


def _on_card(problem) -> bool:
    return problem.x0.is_cuda


def solve_workload(w: Workload, settings: SolverSettings = None,
                   use_fast_path="auto", globalization: str = None,
                   verbose: bool = False) -> SolveResult:
    """Solve one workload (its warm start included) on the device of its
    problem; the result is the scenario's, without a batch axis.

    ``use_fast_path``: ``"auto"`` takes the lane route (the kernels) when
    the problem lives on a CUDA device and ``supports_fast_path`` accepts
    it, else the generic route (with a warning that names the reason on a
    CUDA problem it refuses, as the JAX package warns); ``True`` or ``"lanes"`` the lane route,
    ``False`` the generic one. ``globalization="homotopy"`` runs the
    stiffness-bound continuation (``solvers/homotopy.py``) with a stage
    budget of ``maxiter // n_stages``, so the total budget is the
    preset's. ``verbose`` prints the per-iteration table (the reference's
    ``CallbackVerbose``, ``examples/two_dof_sea.py:75``)."""
    from ..kernels.vsa_kernels import supports_fast_path
    from ..parallel.batch import make_batched_solver
    from ..solvers.homotopy import DEFAULT_SCALES, stiffness_continuation

    p = w.problem
    use_gaps = w.solver in ("fddp", "boxfddp")
    bounds = w.bounds if w.solver in ("boxddp", "boxfddp") else None
    scales, ub_stages = DEFAULT_SCALES, None
    if globalization == "homotopy":
        scales, ub_stages = stiffness_continuation(p, bounds)
    if settings is None:
        maxiter = w.maxiter
        if globalization == "homotopy":
            maxiter = max(1, maxiter // len(scales))
        settings = SolverSettings(maxiter=maxiter, th_stop=w.th_stop)
    if use_fast_path == "auto":
        use_fast_path = False
        if _on_card(p):
            use_fast_path, reason = supports_fast_path(p, bounds)
            if not use_fast_path:
                import warnings
                warnings.warn(f"fast path unavailable for this problem ({reason}); "
                              "using the generic path", stacklevel=2)
    route = "lanes" if use_fast_path in (True, "lanes") else False
    fn = make_batched_solver(p, settings, use_gaps=use_gaps, bounds=bounds,
                             warm_start=w.warm_start, keep_log=verbose or not route,
                             use_fast_path=route, globalization=globalization,
                             scales=scales, ub_stages=ub_stages)
    res = fn(p.x0[None])
    res = SolveResult(*[f[0] for f in res[:-1]], SolveLog(*[f[0] for f in res.log]))
    if verbose:
        from ..utils.verbose import print_iteration_table
        print_iteration_table(res.log, res.iterations)
    return res


def run_workload(name_or_workload, settings: SolverSettings = None,
                 globalization: str = None, verbose: bool = False,
                 **kwargs) -> WorkloadResult:
    """Solve a preset by name (``kwargs`` go to the preset, e.g. ``T``,
    ``device``) or a :class:`Workload`, and report its final end-effector
    translation and control effort."""
    w = (PRESETS[name_or_workload](**kwargs) if isinstance(name_or_workload, str)
         else name_or_workload)
    res = solve_workload(w, settings, globalization=globalization, verbose=verbose)
    if w.ee_frame is not None:
        q_l = res.xs[-1][: w.problem.state.nl]
        ee = rbd.frame_placement(w.problem.state.robot, q_l, w.ee_frame).trans
    else:
        ee = torch.zeros(3, dtype=res.xs.dtype, device=res.xs.device)
    return WorkloadResult(result=res, ee_final=ee, u_sq=u_squared(res.us))
