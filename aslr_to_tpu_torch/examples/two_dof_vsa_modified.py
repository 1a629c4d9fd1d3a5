"""2-DoF VSA with joint trajectory and stiffness optimization, the port of
``examples/two_dof_vsa_modified.py``: a linear stiffness cost (lambda=10),
the stiffness bounded below by 0.002, BoxDDP, T=200. ``--maxiter``
replaces the preset's budget, ``--plot`` draws the figures.
"""
from aslr_to_tpu_torch.examples import cli, settings_of


def main(T: int = 200, maxiter: int = 0, device: str = "cuda", plot: bool = False):
    from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_modified
    from aslr_to_tpu_torch.workloads.run import run_workload

    w = two_dof_vsa_modified(T=T, device=device)
    out = run_workload(w, settings_of(maxiter, w.th_stop))
    res = out.result
    print("Finally reached = ", out.ee_final.cpu().numpy())
    print("iterations:", int(res.iterations), "cost:", float(res.cost))
    print("printing usquared")
    print(float(out.u_sq.sum()))
    if plot:
        from aslr_to_tpu_torch.utils.plotting import plot_oc_solution, plot_stiffness
        plot_stiffness(res.us, show=False)
        plot_oc_solution(res.xs, res.us, stiffness=True, fig_index=1, show=True)
    return out


if __name__ == "__main__":
    cli(main)
