"""Entry points of the port, the counterparts of ``__graft_entry__.py``.

``entry()`` gives a batched BoxDDP solve step on the flagship workload
(``two_dof_vsa_boxddp``) through both production routes, the generic
solver and the lane solver, with example arguments. ``dryrun_multichip(n)``
runs the five production families through ``sharded_solve`` over n
devices at T=6. Both run on the card unless the caller names the CPU.
"""
from __future__ import annotations

import dataclasses

import torch


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


def dryrun_multichip(n_devices: int, device_type: str = "cuda", dtype=torch.float32) -> None:
    """Run the production families through ``sharded_solve`` over
    ``n_devices`` devices (CUDA devices 0 .. n-1, or the CPU n times with
    ``device_type="cpu"``) at T=6, maxiter 2, 2 scenarios a device: the
    generic BoxDDP, the lane BoxDDP, the SEA FDDP lanes, the lane homotopy
    with a stage box, and the per-knot problem with ``[T, nu]`` box tables;
    each result's shape and finiteness are checked."""
    from .parallel.batch import sharded_solve
    from .solvers.ddp import Bounds, SolverSettings
    from .solvers.problem import stack_knots
    from .workloads.presets import two_dof_sea, two_dof_vsa_boxddp

    if device_type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) found "
                               f"{torch.cuda.device_count()} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device(device_type)] * n_devices
    dev = devices[0]
    w = two_dof_vsa_boxddp(T=6, dtype=dtype, device=dev)
    B = 2 * n_devices
    x0s = _x0s(B, w.problem.state.nx, 1, dtype, dev)
    settings = SolverSettings(maxiter=2, th_stop=1e-6)

    def run(problem, use_gaps, bounds, **kw):
        res = sharded_solve(problem, x0s, settings, use_gaps=use_gaps, bounds=bounds,
                            devices=devices, **kw)
        _check(res.cost.shape == (B,) and res.us.shape == (B, problem.T, problem.nu),
               f"shapes {tuple(res.cost.shape)}, {tuple(res.us.shape)}")
        return res

    res = run(w.problem, False, w.bounds)
    _check(bool(torch.isfinite(res.cost.mean())), "the generic BoxDDP's mean cost")
    for res in (
        run(w.problem, False, w.bounds, use_fast_path="lanes"),
        run(two_dof_sea(T=6, dtype=dtype, device=dev).problem, True, None,
            use_fast_path="lanes"),
        run(w.problem, False, w.bounds, use_fast_path="lanes", globalization="homotopy",
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
    res = run(pk_prob, False, pk_bounds, use_fast_path="lanes")
    _check(bool(torch.isfinite(res.cost).all()), f"the per-knot costs {res.cost}")

