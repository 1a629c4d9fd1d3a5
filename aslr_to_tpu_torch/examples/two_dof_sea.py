"""2-DoF SEA arm reach, the port of ``examples/two_dof_sea.py``: FDDP, T=100,
dt=1e-2, quasi-static warm start, th_stop=1e-7, with the per-iteration
table; prints the initial and final end-effector positions and the control
effort as the reference does (its ``examples/two_dof_sea.py:82-93``).
``--maxiter`` replaces the preset's budget, ``--plot`` draws the figures.
"""
from aslr_to_tpu_torch.examples import cli, settings_of


def main(T: int = 100, maxiter: int = 0, device: str = "cuda", plot: bool = False):
    from aslr_to_tpu_torch.ops import rigid_body as rbd
    from aslr_to_tpu_torch.workloads.presets import two_dof_sea
    from aslr_to_tpu_torch.workloads.run import run_workload

    w = two_dof_sea(T=T, device=device)
    out = run_workload(w, settings_of(maxiter, w.th_stop), verbose=True)
    res = out.result
    ee0 = rbd.frame_placement(w.problem.state.robot, w.problem.x0[:2], w.ee_frame).trans
    print("Initial position = ", ee0.cpu().numpy())
    print("Finally reached = ", out.ee_final.cpu().numpy())
    print("converged:", bool(res.converged), "iterations:", int(res.iterations),
          "cost:", float(res.cost), "stop:", float(res.stop))
    print("printing usquared")
    print(float(out.u_sq.sum()))
    if plot:
        from aslr_to_tpu_torch.utils.plotting import plot_kkt_error, plot_oc_solution
        plot_oc_solution(res.xs, res.us, fig_index=1, show=False)
        plot_kkt_error(res.log.stops, fig_index=2, show=True)
    return out


if __name__ == "__main__":
    cli(main)
