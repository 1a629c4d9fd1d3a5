"""Explicit SPMD solving: a rank a device, each solving its shard at once.

PyTorch counterpart of ``aslr_to_tpu/parallel/spmd.py``. Where JAX maps
the batched solver over a mesh with ``shard_map``, the port runs one
process a device (:mod:`.mesh`, :mod:`.launch`): every rank is given the
same global ``x0s [B, nx]``, solves its contiguous rows with
:func:`.batch.make_batched_solver` on its own device, at the same time as
the other ranks, and gathers the whole result with ``all_gather`` in rank
order, as JAX's ``out_specs=P(axis)`` does. The global statistics
``(n_converged, mean_cost)`` are reduced with a SUM across the ranks, as
JAX's ``psum``, so every rank holds the same figures. The scenarios are
independent, so each lane's result is the unsharded solve's: the kernels
of the route run on each rank's card as in one process.

JAX's varying-manual-axes check (``_check_vma``, ``utils/vma.py``) has no
counterpart: nothing here is traced.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..solvers.ddp import Bounds, SolveLog, SolveResult, SolverSettings
from ..solvers.problem import ShootingProblem, to_device
from .batch import make_batched_solver
from .mesh import BatchMesh, make_batch_mesh


def _shard_solver(problem, settings, use_gaps, bounds, warm_start, use_fast_path, mesh,
                  solver_kwargs):
    """The mesh and ``solve_shard(x0s) -> SolveResult``: this rank's rows
    of the global ``x0s``, solved on its device."""
    mesh = mesh or make_batch_mesh()
    dev = mesh.device or problem.x0.device
    inner = make_batched_solver(problem.to(dev), settings, use_gaps, to_device(bounds, dev),
                                warm_start=warm_start, use_fast_path=use_fast_path,
                                **to_device(solver_kwargs, dev))

    def solve_shard(x0s):
        return inner(mesh.shard(x0s).to(dev))

    return mesh, solve_shard


def gather_result(res: SolveResult, mesh: BatchMesh) -> SolveResult:
    """Every rank's ``res`` (its shard, on its device) concatenated in rank
    order, on every rank, on the device of ``res``. The fields keep their
    dtypes and bits: they travel as bytes, in one ``all_gather`` of a
    buffer a rank."""
    if mesh.size == 1:
        return res
    leaves = [*res[:-1], *res.log]
    flat = torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in leaves])
    flat = flat.to(mesh.collective_device)
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(parts, flat)
    out, offset = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        # clone: a dtype view needs its own storage to start aligned
        out.append(torch.cat([p[offset:offset + n].clone().view(t.dtype).view(t.shape)
                              for p in parts]).to(t.device))
        offset += n
    k = len(res) - 1
    return SolveResult(*out[:k], SolveLog(*out[k:]))


def local_stats(converged: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """A shard's ``[converged count, cost sum, scenarios]`` in float32, as
    JAX sums them before its ``psum`` (``spmd.py:92-97``)."""
    return torch.stack([converged.to(torch.float32).sum(), cost.to(torch.float32).sum(),
                        torch.tensor(float(cost.shape[0]), dtype=torch.float32,
                                     device=cost.device)])


def global_stats(res: SolveResult, mesh: BatchMesh):
    """``(n_converged, mean_cost)`` over every rank's shard: the shards'
    :func:`local_stats` all-reduced with a SUM, the cost sum over the
    count; float32 0-d tensors on the device of ``res``, equal on every
    rank."""
    sums = local_stats(res.converged, res.cost)
    if mesh.size > 1:
        sums = sums.to(mesh.collective_device)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        sums = sums.to(res.cost.device)
    return sums[0], sums[1] / sums[2]


def stats_of(res: SolveResult, n_shards: int):
    """:func:`global_stats` computed from a gathered (or an unsharded)
    result: the :func:`local_stats` of ``n_shards`` contiguous shards,
    summed in shard order. Equal to the ranks' figures to the bit where
    the collective adds in that order (two ranks always do)."""
    per = res.cost.shape[0] // n_shards
    rows = [slice(i * per, (i + 1) * per) for i in range(n_shards)]
    total = sum(local_stats(res.converged[r].clone(), res.cost[r].clone()) for r in rows)
    return total[0], total[1] / total[2]


def make_shard_map_solver(
    problem: ShootingProblem,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = True,
    bounds: Optional[Bounds] = None,
    warm_start: bool = False,
    use_fast_path=False,
    mesh: Optional[BatchMesh] = None,
    **solver_kwargs,
):
    """Build ``fn(x0s) -> SolveResult``: every rank of ``mesh`` (default
    :func:`.mesh.make_batch_mesh`) solves its rows of the global ``x0s``
    with :func:`.batch.make_batched_solver` (``use_fast_path``,
    ``warm_start`` and ``solver_kwargs`` passed on) on ``problem.to`` its
    device, and every rank returns the whole result, logs included,
    gathered in rank order. ``x0s.shape[0]`` must divide evenly by the
    mesh size."""
    mesh, solve_shard = _shard_solver(problem, settings, use_gaps, bounds, warm_start,
                                      use_fast_path, mesh, solver_kwargs)
    return lambda x0s: gather_result(solve_shard(x0s), mesh)


def shard_map_solve(
    problem: ShootingProblem,
    x0s: torch.Tensor,
    settings: SolverSettings = SolverSettings(),
    use_gaps: bool = True,
    bounds: Optional[Bounds] = None,
    warm_start: bool = False,
    use_fast_path=False,
    mesh: Optional[BatchMesh] = None,
    **solver_kwargs,
):
    """Solve a scenario batch a shard a rank of ``mesh``. Returns
    ``(result, (n_converged, mean_cost))``: the gathered
    :class:`SolveResult` and the global statistics (:func:`global_stats`),
    identical on every rank. ``solver_kwargs`` pass through to
    :func:`.batch.make_batched_solver` (``globalization``, ``scales``,
    ``ub_stages``, ``keep_log``, ...)."""
    mesh, solve_shard = _shard_solver(problem, settings, use_gaps, bounds, warm_start,
                                      use_fast_path, mesh, solver_kwargs)
    res = solve_shard(x0s)
    stats = global_stats(res, mesh)
    return gather_result(res, mesh), stats
