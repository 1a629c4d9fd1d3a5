"""Time the solver's two forms of the backtracking line search on each route.

``solvers/ddp.py`` tries the step lengths either one a round with early
exit (a host read a round; the lanes still searching roll out again at the
next step length) or all at once (``_all_trials_at_once``: every step
length rolled out in one batch of ``n_alphas`` copies, each lane taking its
first accepting one). Both give each lane the same step length. This script
forces each form in turn on the same solver and inputs, in the order
rounds, batched, batched, rounds, and prints each solve's wall time, the
mean of each form, and how far the two forms' results differ (the lanes
whose costs differ, with the first few costs of each form).

    python -m aslr_to_tpu_torch.line_search_ab --device cuda
    python -m aslr_to_tpu_torch.line_search_ab --device cpu

Cases: the double pendulum on the generic route (FDDP, K4 backward on the
card, its plain version on the CPU), the 2-DoF BoxDDP on the generic route,
and on the fast route (K1/K6 and the Riccati kernels on the card, their
plain versions on the CPU) the 2-DoF SEA FDDP and the 2-DoF VSA BoxDDP. On
the card the sizes are measure.py's paths, the generic ones with fewer
passes; on the CPU they are the tests' sizes. The last line is one JSON
record of every case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _x0s(x0, B, seed):
    """x0 plus 0.05 randn [B, nx], drawn in float64 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    d = 0.05 * torch.randn(B, x0.shape[-1], generator=g, dtype=torch.float64)
    return x0 + d.to(dtype=x0.dtype, device=x0.device)


def _case(kind, route, B, T, maxiter, dtype, device):
    """(solver, x0s) of one case."""
    from . import (SolverSettings, double_pendulum, make_batched_solver, two_dof_sea,
                   two_dof_vsa_boxddp)

    fast = route == "fast"
    if kind == "pendulum":
        w = double_pendulum(T=T, dtype=dtype, device=device)
        settings = SolverSettings(maxiter=maxiter, th_stop=1e-9, use_pallas_backward=True)
        use_gaps, bounds = True, None
    elif kind == "sea":
        w = two_dof_sea(T=T, dtype=dtype, device=device)
        settings = SolverSettings(maxiter=maxiter, th_stop=1e-5)
        use_gaps, bounds = True, None
    else:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device=device)
        settings = SolverSettings(maxiter=maxiter, th_stop=1e-5, boxqp_warm_iters=2)
        use_gaps, bounds = False, w.bounds
    solve = make_batched_solver(w.problem, settings, use_gaps=use_gaps, bounds=bounds,
                                use_fast_path=True if fast else False)
    return solve, _x0s(w.problem.x0, B, seed=7)


CASES = {
    # (kind, route, B, T, maxiter, dtype)
    "cuda": [("pendulum", "generic", 4096, 10, 20, torch.float32),
             ("boxddp", "generic", 256, 100, 2, torch.float32),
             ("sea", "fast", 4096, 100, 60, torch.float32),
             ("boxddp", "fast", 4096, 100, 20, torch.float32)],
    "cpu": [("pendulum", "generic", 8, 10, 20, torch.float64),
            ("pendulum", "generic", 64, 10, 100, torch.float64),
            ("pendulum", "generic", 1024, 10, 20, torch.float32),
            ("boxddp", "generic", 256, 100, 2, torch.float32),
            ("sea", "generic", 8, 100, 20, torch.float64),
            ("sea", "fast", 8, 100, 20, torch.float64),
            ("boxddp", "fast", 8, 100, 20, torch.float64)],
}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run_case(kind, route, B, T, maxiter, dtype, device):
    from .solvers import ddp

    solve, x0s = _case(kind, route, B, T, maxiter, dtype, device)
    policy = ddp._all_trials_at_once
    times, res = {"rounds": [], "batched": []}, {}
    try:
        solve(x0s)      # set-up: the kernels built and loaded
        _sync(device)
        for form in ("rounds", "batched", "batched", "rounds"):
            ddp._all_trials_at_once = lambda fast, f=form: f == "batched"
            t0 = time.perf_counter()
            res[form] = solve(x0s)
            _sync(device)
            times[form].append(time.perf_counter() - t0)
    finally:
        ddp._all_trials_at_once = policy
    a, b = res["rounds"], res["batched"]
    same = ((a.iterations == b.iterations) & (a.converged == b.converged)
            & (a.diverged == b.diverged))
    c_rel = ((a.cost - b.cost).abs() / b.cost.abs()).nan_to_num(0.0)
    differ = torch.nonzero(a.cost != b.cost).flatten().tolist()
    out = dict(kind=kind, route=route, B=B, T=T, maxiter=maxiter, dtype=str(dtype),
               device=device, default="batched" if policy(None if route == "generic"
                                                          else object()) else "rounds",
               rounds_s=times["rounds"], batched_s=times["batched"],
               rounds_mean_s=sum(times["rounds"]) / 2, batched_mean_s=sum(times["batched"]) / 2,
               lanes_equal_flags=int(same.sum()), cost_lanes_differ=len(differ),
               cost_max_rel=float(c_rel.max()),
               cost_differ_first=[(lane, float(a.cost[lane]), float(b.cost[lane]))
                                  for lane in differ[:5]],
               mean_iterations=float(b.iterations.float().mean()))
    print(f"{kind} {route} B={B} T={T} maxiter={maxiter} {dtype} on {device}: rounds "
          f"{times['rounds']} s, batched {times['batched']} s (the route's default: "
          f"{out['default']}); iterations and flags equal on {out['lanes_equal_flags']}/{B} "
          f"lanes, costs differ on {len(differ)} lanes (max rel {out['cost_max_rel']:.3e}; the "
          f"first, rounds / batched: {out['cost_differ_first']}); mean iterations "
          f"{out['mean_iterations']:.2f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--threads", type=int, default=4, help="CPU threads (--device cpu)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA device")
        from .kernels import build
        build.build()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    else:
        torch.set_num_threads(args.threads)
        print(f"CPU, {torch.get_num_threads()} threads")
    records = [run_case(*c, args.device) for c in CASES[args.device]]
    print(json.dumps(records))


if __name__ == "__main__":
    main()
