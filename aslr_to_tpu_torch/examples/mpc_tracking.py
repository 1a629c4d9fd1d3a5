"""Per-knot MPC tracking, the port of ``examples/mpc_tracking.py``: the SEA
arm follows a frame target swept along an arc, one action model a knot
(``with_frame_targets``, stacked by ``stack_knots``). One FDDP solve
(T=60, maxiter 60, th_stop 1e-7) and the end effector's distance from the
target at three knots; with ``--batch B`` instead a timed batch of B
perturbed scenarios on the lane route (the target a table of the
kernels; maxiter 30, ``--reps`` timed solves after a first), with its
convergence.
"""
import time

import torch

from aslr_to_tpu_torch.examples import cli


def target_at(t, T):
    """The arc's point at knot t: y from 0.05 to 0.2, x and z fixed."""
    return [0.01, 0.05 + 0.15 * t / T, 0.18]


def bench_lane_batch(prob, B, maxiter=30, reps=3):
    """``reps`` timed lane-route solves of the per-knot problem at a batch
    of B, after a first one."""
    from aslr_to_tpu_torch.parallel.batch import convergence_summary, make_batched_solver
    from aslr_to_tpu_torch.solvers.ddp import SolverSettings

    fn = make_batched_solver(prob, SolverSettings(maxiter=maxiter, th_stop=1e-5),
                             use_gaps=True, bounds=None, use_fast_path="lanes")
    g = torch.Generator().manual_seed(0)
    x0s = prob.x0 + (0.05 * torch.randn(B, prob.x0.shape[0], generator=g,
                                        dtype=torch.float64)).to(prob.x0)
    out = fn(x0s)
    out.cost.cpu()
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn(x0s + 1e-4 * (i + 1))
        out.cost.cpu()
    rate = B * reps / (time.perf_counter() - t0)
    summary = convergence_summary(out)
    print(f"lane-path per-knot tracking: {rate:.0f} solves/s at B={B}, convergence {summary}")
    return out, summary


def main(T: int = 60, maxiter: int = 60, batch: int = 0, reps: int = 3, device: str = "cuda"):
    from aslr_to_tpu_torch.models.costs import ResidualModelFramePlacementASR
    from aslr_to_tpu_torch.ops import rigid_body as rbd
    from aslr_to_tpu_torch.solvers.ddp import SolverFDDP, SolverSettings
    from aslr_to_tpu_torch.workloads.presets import two_dof_sea, with_frame_targets

    w = two_dof_sea(T=T, device=device)
    p = w.problem
    goal = next(it.cost.residual for it in p.running.differential.costs.items
                if isinstance(getattr(it.cost, "residual", None),
                              ResidualModelFramePlacementASR))
    rot = goal.placement.rot.expand(T, 3, 3)
    trans = torch.tensor([target_at(t, T) for t in range(T)], dtype=p.x0.dtype)
    prob = with_frame_targets(p, rot, trans)
    if batch:
        return bench_lane_batch(prob, batch, reps=reps)

    res = SolverFDDP(prob).solve(settings=SolverSettings(maxiter=maxiter, th_stop=1e-7))
    print(f"converged={bool(res.converged)} iterations={int(res.iterations)} "
          f"cost={float(res.cost):.4f}")
    robot = p.state.robot
    errs = []
    for t in (0, T // 2, T):
        ee = rbd.frame_placement(robot, res.xs[t][:2], w.ee_frame).trans
        tgt = torch.tensor(target_at(min(t, T - 1), T), dtype=ee.dtype, device=ee.device)
        errs.append(float(torch.linalg.norm(ee - tgt)))
        print(f"  t={t:3d}: EE={ee.cpu().numpy().round(4)} "
              f"target={tgt.cpu().numpy().round(4)} err={errs[-1]:.4f}")
    return res, errs


if __name__ == "__main__":
    cli(main)
