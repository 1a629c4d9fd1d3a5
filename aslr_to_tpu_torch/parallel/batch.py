"""Batched solving: the throughput axis of the port.

PyTorch counterpart of ``aslr_to_tpu/parallel/batch.py``:
``make_batched_solver`` (the generic per-scenario solver, its fused fast
path, and the lane solver, each also with the terminal-weight homotopy),
``sharded_solve`` (the batch split over devices, a shard a device: in
series in this process, or a rank a device through :mod:`.spmd`) and
``convergence_summary``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..kernels.lane_solver import build_lane_homotopy, build_lane_solver, check_device
from ..kernels.vsa_kernels import build_fast_path
from ..solvers.ddp import Bounds, SolveLog, SolveResult, SolverSettings, solve
from ..solvers.homotopy import DEFAULT_SCALES, homotopy_solve
from ..solvers.problem import ShootingProblem, to_device


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


def sharded_solve(
    problem: ShootingProblem,
    x0s: torch.Tensor,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = True,
    bounds: Optional[Bounds] = None,
    devices=None,
    use_fast_path=False,
    warm_start: bool = False,
    partitioner: str = "shard_map",
    mesh=None,
    **solver_kwargs,
) -> SolveResult:
    """Solve the scenarios ``x0s [B, nx]`` a shard a device, B / n
    contiguous scenarios each, as the JAX package's batch sharding splits
    them over a mesh, by one of two routes:

    - ``mesh`` (a :class:`.mesh.BatchMesh`, from ``distributed_init`` in
      each of a process a device): every rank solves its shard at the same
      time as the others and returns the whole result, gathered in rank
      order (:func:`.spmd.make_shard_map_solver`); PERF.md gives its rates
      over the cards.
    - ``devices`` (default: every visible CUDA device; repeats allowed), in
      this one process: each shard solved by :func:`make_batched_solver`
      on a copy of the problem, the bounds and any tensor argument on its
      device, one shard after another from this thread, the results
      concatenated in order on the first device. A solve's host loop waits
      on its card every pass, so this route's rate does not grow with the
      cards: on four NVIDIA H100 80GB HBM3 (700 W) it gave 0.26-0.37x one
      card's rate at B=4096 and 0.60-0.62x at B=16384 (PERF.md);
      shards in threads of their own ran 4-10x slower than one card, the
      threads queueing for the interpreter lock at every launch.

    Either way ``use_fast_path``, ``warm_start`` and ``solver_kwargs`` (such
    as ``globalization``, ``scales``, ``ub_stages``) pass on, and each
    lane's result is the unsharded solve's. On the ``devices`` route
    ``x0s`` lies on the problem's device, as for every solve; on the
    ``mesh`` route every rank passes the same global ``x0s``. The mesh axis
    name has no counterpart; ``partitioner="gspmd"`` (XLA partitioning the
    whole program) has none either and raises."""
    if partitioner == "gspmd":
        raise ValueError("partitioner='gspmd' has no counterpart in the port: each device "
                         "solves its own shard ('shard_map')")
    if partitioner != "shard_map":
        raise ValueError(f"partitioner must be 'shard_map', got {partitioner!r}")
    if mesh is not None:
        if devices is not None:
            raise ValueError("sharded_solve takes devices (the shards in series in this "
                             "process) or mesh (a rank a device), not both")
        from .spmd import make_shard_map_solver

        return make_shard_map_solver(problem, settings, use_gaps, bounds, warm_start,
                                     use_fast_path, mesh=mesh, **solver_kwargs)(x0s)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sharded_solve found no CUDA device: pass devices=[...] to "
                               "name the devices of the shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("sharded_solve needs at least one device")
    check_device(problem.x0.device, x0s=x0s)
    B, n = x0s.shape[0], len(devices)
    if B % n:
        raise ValueError(f"a batch of {B} scenarios does not split into {n} equal shards")
    per = B // n
    parts = []
    for i, dev in enumerate(devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            fn = make_batched_solver(problem.to(dev), settings, use_gaps,
                                     to_device(bounds, dev), warm_start=warm_start,
                                     use_fast_path=use_fast_path,
                                     **to_device(solver_kwargs, dev))
            parts.append(fn(x0s[i * per:(i + 1) * per].to(dev)))
    first = devices[0]
    return SolveResult(*(torch.cat([getattr(r, f).to(first) for r in parts])
                         for f in SolveResult._fields[:-1]),
                       SolveLog(*(torch.cat([getattr(r.log, f).to(first) for r in parts])
                                  for f in SolveLog._fields)))


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
