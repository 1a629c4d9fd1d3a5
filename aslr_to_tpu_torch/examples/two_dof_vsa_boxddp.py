"""2-DoF VSA reach with BoxDDP, the port of ``examples/two_dof_vsa_boxddp.py``:
T=200, dt=1e-2, u in [-100, 100]^2, K in [0, 100]^2, cold start,
maxiter=400; exports the trajectory as a ``.mat`` file like the reference
(its ``examples/two_dof_vsa_boxddp.py:125-127``) to ``--out``.
``--homotopy`` ramps the terminal goal weight in warm-started stages
within the same budget (``solvers/homotopy.py``). ``--maxiter`` replaces
the preset's budget, ``--plot`` draws the figures.
"""
from aslr_to_tpu_torch.examples import cli, settings_of


def main(T: int = 200, maxiter: int = 0, device: str = "cuda", homotopy: bool = False,
         out: str = "optimised_trajectory_vsa.mat", plot: bool = False):
    from aslr_to_tpu_torch.utils.io import export_mat
    from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.workloads.run import run_workload

    w = two_dof_vsa_boxddp(T=T, device=device)
    sol = run_workload(w, settings_of(maxiter, w.th_stop),
                       globalization="homotopy" if homotopy else None)
    res = sol.result
    print("Finally reached = ", sol.ee_final.cpu().numpy())
    print("iterations:", int(res.iterations), "cost:", float(res.cost))
    print(float(sol.u_sq[:2].sum()))
    export_mat(out, res.xs, res.us, 1e-2)
    if plot:
        from aslr_to_tpu_torch.utils.plotting import plot_oc_solution
        plot_oc_solution(res.xs, res.us, stiffness=True, fig_index=1, show=True)
    return sol


if __name__ == "__main__":
    cli(main)
