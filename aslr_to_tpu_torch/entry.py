"""Entry points of the port, the counterparts of ``__graft_entry__.py``.

``entry()`` gives a batched BoxDDP solve step on the flagship workload
(``two_dof_vsa_boxddp``) through both production routes, the generic
solver and the lane solver, with example arguments. ``dryrun_multichip(n)``
runs the five production families over n devices at T=6 through
``shard_map_solve``, a process a device (or through ``sharded_solve`` in
one process). Both run on the card unless the caller names the CPU.
"""
from __future__ import annotations

import dataclasses

import torch


# seconds a rank of dryrun_multichip's process route may take
RANK_TIMEOUT_S = 600


def _check(ok, what):
    """Raise unless ``ok`` (a check that ``python -O`` keeps)."""
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _x0s(B, nx, seed, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return (0.05 * torch.randn(B, nx, generator=g, dtype=torch.float64)).to(dtype=dtype,
                                                                              device=device)


def entry(device="cuda", dtype=torch.float32):
    """(fn, example_args): one batched BoxDDP solve step of the VSA arm at
    T=20 (maxiter 3, th_stop 1e-6) on ``device``.

    ``fn(x0s) -> (cost_sum, gen_us, lane_us)``: the generic solve's cost
    plus the lane solve's, each lane's, and each route's controls (the
    contract ``tests/test_graft_entry.py`` pins for the JAX package's
    ``entry``). ``example_args`` holds 4 seeded initial states."""
    from .parallel.batch import make_batched_solver
    from .solvers.ddp import SolverSettings
    from .workloads.presets import two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=20, dtype=dtype, device=device)
    settings = SolverSettings(maxiter=3, th_stop=1e-6)
    generic = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds)
    lane = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                               use_fast_path="lanes")

    def fn(x0s):
        gen = generic(x0s)
        lanes = lane(x0s)
        return gen.cost + lanes.cost, gen.us, lanes.us

    return fn, (_x0s(4, w.problem.state.nx, 0, dtype, w.problem.x0.device),)


def dryrun_multichip(n_devices: int, device_type: str = "cuda", dtype=torch.float32,
                     route: str = "processes") -> None:
    """Run the production families over ``n_devices`` devices at T=6,
    maxiter 2, 2 scenarios a device: the generic BoxDDP, the lane BoxDDP,
    the SEA FDDP lanes, the lane homotopy with a stage box, and the
    per-knot problem with ``[T, nu]`` box tables; each result's shape and
    finiteness are checked.

    ``route="processes"`` (as ``__graft_entry__.py`` runs them, through
    ``shard_map_solve``): a rank a device, each solving its shard at the
    same time, the global statistics all-reduced; they are checked finite
    and equal to those computed from the gathered result. Called in a
    group of ``n_devices`` ranks (``distributed_init``), it runs in that
    group; called outside one, it starts ``n_devices`` ranks of ``python -m
    aslr_to_tpu_torch.entry`` (``parallel/launch.py``, each within
    ``RANK_TIMEOUT_S``) on CUDA devices 0 .. n-1 (ranks share a card where
    there are fewer, over Gloo) or, with ``device_type="cpu"``, on the CPU
    over Gloo; one device runs in this process.

    ``route="series"``: ``sharded_solve`` in this process over CUDA devices
    0 .. n-1, or the CPU n times, the shards one after another."""
    if route == "series":
        return _dryrun_series(n_devices, device_type, dtype)
    if route != "processes":
        raise ValueError(f"route must be 'processes' or 'series', got {route!r}")
    from .parallel import launch
    from .parallel.mesh import make_batch_mesh
    from .parallel.spmd import shard_map_solve, stats_of

    mesh = make_batch_mesh()
    if mesh.size == 1 and n_devices > 1:
        launch.run(n_devices, ["-m", "aslr_to_tpu_torch.entry", "--dryrun-multichip",
                               str(n_devices), "--device-type", device_type,
                               "--dtype", str(dtype).removeprefix("torch.")], RANK_TIMEOUT_S)
        return
    if mesh.size != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of {mesh.size} ranks")
    if mesh.device is not None and mesh.device.type != device_type:
        raise ValueError(f"dryrun_multichip(device_type={device_type!r}) on a rank of "
                         f"{mesh.device}")
    dev = mesh.device or (torch.device("cuda", torch.cuda.current_device())
                          if device_type == "cuda" else torch.device(device_type))

    def run(problem, x0s, settings, use_gaps, bounds, **kw):
        res, (n_conv, mean_cost) = shard_map_solve(problem, x0s, settings, use_gaps=use_gaps,
                                                   bounds=bounds, mesh=mesh, **kw)
        _check(bool(torch.isfinite(n_conv)) and bool(torch.isfinite(mean_cost)),
               f"global statistics {float(n_conv)}, {float(mean_cost)}")
        want_conv, want_cost = stats_of(res, mesh.size)
        # summed over the ranks in another order than rank order, the cost
        # may part from the gathered result's by the float32 rounding of a sum
        _check(float(n_conv) == float(want_conv)
               and abs(float(mean_cost) - float(want_cost))
               <= mesh.size * torch.finfo(torch.float32).eps * abs(float(want_cost)),
               f"global statistics {float(n_conv)}, {float(mean_cost)} against "
               f"{float(want_conv)}, {float(want_cost)} from the gathered result")
        return res

    _families(n_devices, dtype, dev, run)


def _families(n_devices, dtype, dev, run):
    """The five families at T=6 on ``dev`` through ``run(problem, x0s,
    use_gaps, bounds, **kw) -> SolveResult``, 2 scenarios a device."""
    from .solvers.ddp import Bounds, SolverSettings
    from .solvers.problem import stack_knots
    from .workloads.presets import two_dof_sea, two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=6, dtype=dtype, device=dev)
    B = 2 * n_devices
    x0s = _x0s(B, w.problem.state.nx, 1, dtype, dev)
    settings = SolverSettings(maxiter=2, th_stop=1e-6)

    def solve(problem, use_gaps, bounds, **kw):
        res = run(problem, x0s, settings, use_gaps, bounds, **kw)
        _check(res.cost.shape == (B,) and res.us.shape == (B, problem.T, problem.nu),
               f"shapes {tuple(res.cost.shape)}, {tuple(res.us.shape)}")
        return res

    res = solve(w.problem, False, w.bounds)
    _check(bool(torch.isfinite(res.cost.mean())), "the generic BoxDDP's mean cost")
    for res in (
        solve(w.problem, False, w.bounds, use_fast_path="lanes"),
        solve(two_dof_sea(T=6, dtype=dtype, device=dev).problem, True, None,
              use_fast_path="lanes"),
        solve(w.problem, False, w.bounds, use_fast_path="lanes", globalization="homotopy",
              scales=(0.5, 1.0),
              ub_stages=torch.tensor([[100.0, 100.0, s, s] for s in (25.0, 100.0)],
                                     dtype=dtype, device=dev)),
    ):
        _check(bool(torch.isfinite(res.cost).all()), f"a lane family's costs {res.cost}")

    T = w.problem.T
    pk_prob = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * T),
                                  per_knot=True)
    pk_bounds = Bounds(
        lb=torch.tensor([-50.0, -50.0, 0.0, 0.0], dtype=dtype, device=dev).repeat(T, 1),
        ub=torch.tensor([50.0, 50.0, 50.0, 50.0], dtype=dtype, device=dev).repeat(T, 1))
    res = solve(pk_prob, False, pk_bounds, use_fast_path="lanes")
    _check(bool(torch.isfinite(res.cost).all()), f"the per-knot costs {res.cost}")


def _dryrun_series(n_devices, device_type, dtype):
    from .parallel.batch import sharded_solve

    if device_type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) found "
                               f"{torch.cuda.device_count()} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device(device_type)] * n_devices

    def run(problem, x0s, settings, use_gaps, bounds, **kw):
        return sharded_solve(problem, x0s, settings, use_gaps=use_gaps, bounds=bounds,
                             devices=devices, **kw)

    _families(n_devices, dtype, devices[0], run)


def _rank_main(argv=None):
    """A rank of ``dryrun_multichip``'s process route (the launcher starts
    ``python -m aslr_to_tpu_torch.entry --dryrun-multichip N ...``)."""
    import argparse

    import torch.distributed as dist

    from .parallel.mesh import distributed_init

    ap = argparse.ArgumentParser(prog="python -m aslr_to_tpu_torch.entry")
    ap.add_argument("--dryrun-multichip", type=int, required=True, metavar="N")
    ap.add_argument("--device-type", default="cuda")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    mesh = distributed_init(device="cpu" if args.device_type == "cpu" else None)
    try:
        dryrun_multichip(args.dryrun_multichip, args.device_type, getattr(torch, args.dtype))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"dryrun_multichip: rank {mesh.rank} of {mesh.size} on {mesh.device} "
          f"({mesh.backend}): the five families ok", flush=True)


if __name__ == "__main__":
    _rank_main()
