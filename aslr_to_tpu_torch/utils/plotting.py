"""Plotting of solved trajectories and convergence.

PyTorch counterpart of ``aslr_to_tpu/utils/plotting.py``, which replaces
the reference's matplotlib helpers (``python/aslr_to/__init__.py:17-221``):
``plotOCSolution`` (state/control/stiffness panels), ``plotSEAOCSolution``,
``plotrigidOCSolution``, ``plot_stiffness``, ``plot_theta``,
``plotKKTerror``, and a convergence figure from a ``SolveLog``. The inputs
are the solver's tensors (``xs [T+1, nx]``, ``us [T, nu]``, a lane's log
series) or numpy arrays, on any device. matplotlib is imported at the
first plot, so the package needs it only to plot.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.rcParams["pdf.fonttype"] = 42
    matplotlib.rcParams["ps.fonttype"] = 42
    import matplotlib.pyplot as plt
    return plt


def plot_oc_solution(xs=None, us=None, stiffness=False, fig_index=1, show=True, fig_title=""):
    """State/control(/stiffness) panels (reference ``plotOCSolution``,
    ``__init__.py:160-221``). For soft states the first nx/4 coordinates
    (link positions) are plotted; for VSA controls the first nu/2 are
    torques and the rest stiffness."""
    plt = _plt()
    fig = plt.figure(fig_index)
    n_panels = (1 if xs is not None else 0) + (1 if us is not None else 0) + (1 if stiffness else 0)
    panel = 1

    if xs is not None:
        xs = _np(xs)
        nx = xs.shape[1] // 4
        ax = fig.add_subplot(n_panels, 1, panel)
        panel += 1
        for i in range(nx):
            ax.plot(xs[:, i], label=f"q{i}")
        ax.set_ylabel("Joint Positions [rad]")
        ax.set_xlabel("Knots")
        ax.legend()
        ax.set_title(fig_title, fontsize=14)

    if us is not None:
        us = _np(us)
        nu = us.shape[1] // 2 if stiffness else us.shape[1]
        ax = fig.add_subplot(n_panels, 1, panel)
        panel += 1
        for i in range(nu):
            ax.plot(us[:, i], label=f"u{i}")
        ax.set_ylabel("Input [Nm]")
        ax.set_xlabel("knots")
        ax.legend()

    if stiffness and us is not None:
        ax = fig.add_subplot(n_panels, 1, panel)
        nu = us.shape[1]
        for i in range(nu // 2, nu):
            ax.plot(us[:, i], label=f"K{i - nu // 2}")
        ax.set_ylabel("Stiffness [Nm/rad]")
        ax.set_xlabel("knots")
        ax.legend()

    if show:
        plt.show()
    return fig


def plot_sea_oc_solution(xs=None, us=None, fig_index=1, show=True, fig_title=""):
    """SEA variant (reference ``plotSEAOCSolution``, ``__init__.py:110-158``)."""
    return plot_oc_solution(xs=xs, us=us, stiffness=False, fig_index=fig_index,
                            show=show, fig_title=fig_title)


def plot_rigid_oc_solution(xs=None, us=None, fig_index=1, show=True, fig_title=""):
    """Rigid-state variant: first nx/2 coordinates are positions
    (reference ``plotrigidOCSolution``, ``__init__.py:69-109``)."""
    plt = _plt()
    fig = plt.figure(fig_index)
    n_panels = (1 if xs is not None else 0) + (1 if us is not None else 0)
    panel = 1
    if xs is not None:
        xs = _np(xs)
        ax = fig.add_subplot(n_panels, 1, panel)
        panel += 1
        for i in range(xs.shape[1] // 2):
            ax.plot(xs[:, i], label=f"q{i}")
        ax.set_ylabel("Joint Positions [rad]")
        ax.set_xlabel("Knots")
        ax.legend()
        ax.set_title(fig_title, fontsize=14)
    if us is not None:
        us = _np(us)
        ax = fig.add_subplot(n_panels, 1, panel)
        for i in range(us.shape[1]):
            ax.plot(us[:, i], label=f"u{i}")
        ax.set_ylabel("Input [Nm]")
        ax.set_xlabel("knots")
        ax.legend()
    if show:
        plt.show()
    return fig


def plot_stiffness(us, show=True):
    """Stiffness half of the VSA controls (reference ``plot_stiffness``,
    ``__init__.py:30-47``)."""
    plt = _plt()
    us = _np(us)
    nu = us.shape[1]
    for i in range(nu // 2, nu):
        plt.plot(us[:, i], label=f"K{i - nu // 2}")
    plt.legend()
    plt.xlabel("knots")
    plt.ylabel("Stiffness [Nm/rad]")
    if show:
        plt.show()


def plot_theta(xs, n_link, show=True):
    """Link angles over knots (reference ``plot_theta``, ``__init__.py:17-28``)."""
    plt = _plt()
    xs = _np(xs)
    for k in range(n_link):
        plt.plot(xs[:, k], label=f"theta_{k}")
    plt.xlabel("Nodes")
    plt.ylabel("theta")
    plt.legend()
    if show:
        plt.show()


def plot_kkt_error(stops, fig_index=1, show=True):
    """Log-scale KKT-error-vs-iteration curve (reference ``plotKKTerror``,
    ``__init__.py:49-61``); feed ``result.log.stops``."""
    plt = _plt()
    plt.figure(fig_index, figsize=(6.4, 8))
    stops = _np(stops)
    stops = stops[np.isfinite(stops)]
    plt.plot(stops, label="KKT error")
    plt.ylabel("KKT error")
    plt.xlabel("iteration")
    plt.yscale("log")
    if show:
        plt.show()


def plot_convergence(log, fig_index=2, show=True):
    """Cost / step-length / regularization / gradient panels from a
    SolveLog (replaces ``crocoddyl.plotConvergence``)."""
    plt = _plt()
    fig = plt.figure(fig_index, figsize=(6.4, 10))
    panels = [
        ("cost", _np(log.costs)),
        ("step length", _np(log.steps)),
        ("regularization", _np(log.regs)),
        ("stop (sum ||Qu||^2)", _np(log.stops)),
        ("gap norm", _np(log.gap_norms)),
    ]
    for i, (name, arr) in enumerate(panels):
        ax = fig.add_subplot(len(panels), 1, i + 1)
        arr = arr[np.isfinite(arr)]
        ax.plot(arr)
        ax.set_ylabel(name)
        if name in ("regularization", "stop (sum ||Qu||^2)") and arr.size and (arr > 0).all():
            ax.set_yscale("log")
    if show:
        plt.show()
    return fig
