"""Soft-actuated double-pendulum swing-up, the port of
``examples/double_pendulum.py``: FDDP, T=10, dt=1e-2, underactuated (the
first joint's motor only). ``--maxiter`` replaces the preset's budget,
``--plot`` draws the figures.
"""
from aslr_to_tpu_torch.examples import cli, settings_of


def main(T: int = 10, maxiter: int = 0, device: str = "cuda", plot: bool = False):
    from aslr_to_tpu_torch.workloads.presets import double_pendulum
    from aslr_to_tpu_torch.workloads.run import run_workload

    w = double_pendulum(T=T, device=device)
    out = run_workload(w, settings_of(maxiter, w.th_stop))
    res = out.result
    print("iterations:", int(res.iterations), "cost:", float(res.cost),
          "converged:", bool(res.converged))
    print("final state:", res.xs[-1].cpu().numpy().round(4))
    if plot:
        from aslr_to_tpu_torch.utils.plotting import plot_convergence, plot_oc_solution
        plot_oc_solution(res.xs, res.us, fig_index=1, show=False)
        plot_convergence(res.log, fig_index=2, show=True)
    return out


if __name__ == "__main__":
    cli(main)
