"""MPC-style warm-started re-solve, the port of ``examples/mpc_resolve.py``:
the SEA reach solved (FDDP, T=60, th_stop 1e-7), its solution saved, then
solved again from the state one knot into the plan with the shifted
solution as the warm start: the receding-horizon pattern, which the warm
start lets finish in fewer iterations. The archive goes to ``--out``
(default: a temporary file, removed after).
"""
import os
import tempfile

from aslr_to_tpu_torch.examples import cli


def main(T: int = 60, maxiter: int = 100, device: str = "cuda", out: str = ""):
    import torch

    from aslr_to_tpu_torch.solvers.ddp import SolverFDDP, SolverSettings
    from aslr_to_tpu_torch.utils.io import load_solution, save_solution
    from aslr_to_tpu_torch.workloads.presets import two_dof_sea

    w = two_dof_sea(T=T, device=device)
    p = w.problem
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-7)
    first = SolverFDDP(p).solve(settings=settings)
    print(f"cold solve: {int(first.iterations)} iterations, cost {float(first.cost):.4f}")

    path = out or tempfile.mkstemp(suffix=".npz")[1]
    try:
        save_solution(path, first.xs, first.us, dt=1e-2)
        xs_prev, us_prev = load_solution(path, device=p.x0.device)
    finally:
        if not out:
            os.remove(path)
    # the new initial state is one knot into the previous plan, and the
    # warm start the plan shifted by a knot
    import dataclasses
    p2 = dataclasses.replace(p, x0=xs_prev[1])
    xs_ws = torch.cat([xs_prev[1:], xs_prev[-1:]])
    us_ws = torch.cat([us_prev[1:], us_prev[-1:]])
    warm = SolverFDDP(p2).solve(xs_ws, us_ws, settings=settings)
    print(f"warm re-solve: {int(warm.iterations)} iterations, cost {float(warm.cost):.4f}")
    assert int(warm.iterations) <= int(first.iterations)
    return first, warm


if __name__ == "__main__":
    cli(main)
