"""The port's plots (``aslr_to_tpu_torch/utils/plotting.py``) against the
JAX package's (``aslr_to_tpu/utils/plotting.py``): each of the seven
functions on the same inputs (numpy arrays for JAX, tensors for the port),
drawn with the Agg backend and ``show=False``, must give the same figures,
axes, labels, scales and line data.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from aslr_to_tpu.utils import plotting as jax_plotting  # noqa: E402
from aslr_to_tpu_torch.solvers.ddp import SolveLog  # noqa: E402
from aslr_to_tpu_torch.utils import plotting  # noqa: E402


def _inputs():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((11, 8))
    us = rng.standard_normal((10, 4))
    series = np.abs(rng.standard_normal((7, 6))) + 0.1
    series[:, 4:] = np.nan          # NaN past the last iteration
    return xs, us, series


# case: (function, its arguments from xs, us and a log)
CASES = {
    "oc_solution": ("plot_oc_solution", lambda xs, us, log: dict(xs=xs, us=us, fig_title="r")),
    "oc_solution_stiffness": ("plot_oc_solution",
                              lambda xs, us, log: dict(xs=xs, us=us, stiffness=True)),
    "sea_oc_solution": ("plot_sea_oc_solution",
                        lambda xs, us, log: dict(xs=xs, us=us[:, :2], fig_title="sea")),
    "rigid_oc_solution": ("plot_rigid_oc_solution",
                          lambda xs, us, log: dict(xs=xs[:, :4], us=us[:, :2])),
    "stiffness": ("plot_stiffness", lambda xs, us, log: dict(us=us)),
    "theta": ("plot_theta", lambda xs, us, log: dict(xs=xs, n_link=2)),
    "kkt_error": ("plot_kkt_error", lambda xs, us, log: dict(stops=log.stops)),
    "convergence": ("plot_convergence", lambda xs, us, log: dict(log=log)),
}


def _drawn(fn, kwargs):
    """Each open figure's axes after ``fn(**kwargs, show=False)``: title,
    labels, y scale, and every line's label and data; the figures closed."""
    import matplotlib.pyplot as plt

    plt.close("all")
    fn(**kwargs, show=False)
    out = []
    for num in plt.get_fignums():
        for ax in plt.figure(num).axes:
            out.append((num, ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                        ax.get_yscale(), [(ln.get_label(), np.asarray(ln.get_xdata()),
                                           np.asarray(ln.get_ydata()))
                                          for ln in ax.get_lines()]))
    plt.close("all")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plot_matches_jax(case):
    xs, us, series = _inputs()
    name, args = CASES[case]
    np_log = SolveLog(*series)
    torch_log = SolveLog(*(torch.tensor(s) for s in series))
    want = _drawn(getattr(jax_plotting, name), args(xs, us, np_log))
    got = _drawn(getattr(plotting, name), args(torch.tensor(xs), torch.tensor(us), torch_log))
    assert want and len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        assert len(g[5]) == len(w[5]) > 0
        for (gl, gx, gy), (wl, wx, wy) in zip(g[5], w[5]):
            assert gl == wl
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
