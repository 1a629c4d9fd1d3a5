"""Regenerate ``vsa_homotopy_T100_lanes.npz``: the JAX package's LANE route
on the configuration of ``tests/golden/vsa_homotopy_T100.npz`` (the staged
stiffness-bound continuation of ``two_dof_vsa_boxddp(T=100)`` from x0 = 0,
maxiter 20 a stage, th_stop 1e-5, f64).

The golden pins the JAX package's generic route. This solve is chaotic
after its second stage: the port's lane route parts from the generic route
at the last pass of stage 2 (``--replay``) and ends 0.31% higher, where
JAX's own lane route ends too. The port's lane route (its kernels on the
card, their plain versions on the CPU) follows JAX's lane route, so
``chip_smoke.py``'s golden phase holds it to this file, at the golden's
tolerances, and prints its distance from the generic golden.

    python tests/data_torch/gen_vsa_homotopy_T100_lanes.py [--replay]

from the repository's root runs the Pallas lane kernels in interpret mode
on the CPU (about 3 min) and writes the file. ``--replay`` also solves the
stages one by one with the JAX package's generic ``solve`` and with the
port's generic and lane routes on the CPU (about 8 min more), and prints
each stage's cost and the largest relative difference of each route's
per-iteration costs from JAX's generic route, with the first pass where
it passes 1e-8.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from aslr_to_tpu.parallel.batch import make_batched_solver  # noqa: E402
from aslr_to_tpu.solvers.ddp import Bounds, SolverSettings, solve  # noqa: E402
from aslr_to_tpu.solvers.homotopy import scale_terminal_costs, stiffness_continuation  # noqa: E402
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SETTINGS = dict(maxiter=20, th_stop=1e-5)


def lane_route():
    w = two_dof_vsa_boxddp(T=100)
    scales, ub_stages = stiffness_continuation(w.problem, w.bounds)
    solve_lanes = make_batched_solver(w.problem, SolverSettings(**SETTINGS), use_gaps=False,
                                      bounds=w.bounds, use_fast_path="lanes",
                                      globalization="homotopy", scales=scales,
                                      ub_stages=ub_stages)
    res = solve_lanes(jnp.zeros((1, 8)))
    golden = np.load(os.path.join(HERE, "..", "golden", "vsa_homotopy_T100.npz"))
    np.savez(os.path.join(HERE, "vsa_homotopy_T100_lanes.npz"), cost=np.asarray(res.cost[0]),
             us=np.asarray(res.us[0]), iters=np.asarray(res.iterations[0]),
             diverged=np.asarray(res.diverged[0]), generic_cost=golden["cost"])
    print(f"lane route: cost {float(res.cost[0])!r}, iterations {int(res.iterations[0])}; "
          f"generic golden {float(golden['cost'])!r}", flush=True)


def stage_logs_jax():
    w = two_dof_vsa_boxddp(T=100)
    scales, ub_stages = stiffness_continuation(w.problem, w.bounds)
    one = jax.jit(lambda p, xs, us, b: solve(p, xs, us, settings=SolverSettings(**SETTINGS),
                                             use_gaps=False, bounds=b))
    xs, us = jnp.broadcast_to(w.problem.x0, (101, 8)), jnp.zeros((100, 4))
    logs = []
    for i, s in enumerate(scales):
        r = one(scale_terminal_costs(w.problem, s), xs, us, Bounds(w.bounds.lb, ub_stages[i]))
        xs, us = r.xs, r.us
        logs.append(np.asarray(r.log.costs))
    return logs


def stage_logs_port(route):
    import torch

    from aslr_to_tpu_torch import SolverSettings as PortSettings
    from aslr_to_tpu_torch import scale_terminal_costs as port_scale
    from aslr_to_tpu_torch import solve as port_solve
    from aslr_to_tpu_torch import stiffness_continuation as port_stiffness
    from aslr_to_tpu_torch import two_dof_vsa_boxddp as port_vsa
    from aslr_to_tpu_torch import Bounds as PortBounds
    from aslr_to_tpu_torch.kernels.lane_solver import build_lane_solver
    from aslr_to_tpu_torch.solvers.homotopy import stage_arrays

    torch.set_num_threads(1)
    w = port_vsa(T=100, device="cpu")
    scales, ub_stages = port_stiffness(w.problem, w.bounds)
    st = PortSettings(**SETTINGS)
    scale_arr, ub_arr = stage_arrays(scales, ub_stages, torch.float64, "cpu")
    lane = build_lane_solver(w.problem, st, w.bounds, keep_log=True)
    x0s = torch.zeros(1, 8, dtype=torch.float64)
    xs = us = None
    logs = []
    for i in range(len(scales)):
        if route == "lanes":
            r = lane(x0s, xs, us, wterm_scale=scale_arr[i], box_ub=ub_arr[i])
        else:
            p = dataclasses.replace(port_scale(w.problem, scale_arr[i]), x0=x0s)
            r = port_solve(p, xs, us, settings=st, use_gaps=False,
                           bounds=PortBounds(w.bounds.lb, ub_arr[i]))
        xs, us = r.xs, r.us
        logs.append(r.log.costs[0].numpy())
    return logs


def replay():
    ref = stage_logs_jax()
    print("JAX generic, stage costs: " + ", ".join(repr(float(c[-1])) for c in ref), flush=True)
    for route in ("generic", "lanes"):
        logs = stage_logs_port(route)
        print(f"port {route}, stage costs: " + ", ".join(repr(float(c[-1])) for c in logs))
        for i, (got, want) in enumerate(zip(logs, ref)):
            rel = np.abs(got - want) / np.abs(want)
            part = np.nonzero(rel > 1e-8)[0]
            print(f"  stage {i}: max rel diff {rel.max():.3e}, first pass over 1e-8: "
                  f"{int(part[0]) if part.size else None}", flush=True)


if __name__ == "__main__":
    lane_route()
    if "--replay" in sys.argv[1:]:
        replay()
