"""The example scripts of the port, the counterparts of ``examples/``.

Each module has a ``main(...)`` that takes its sizes and ``device`` (the
card by default) as keyword arguments and runs as ``python -m
aslr_to_tpu_torch.examples.<name> [--T 20] [--device cpu] [--plot]``: the
command line's options are ``main``'s keywords (:func:`cli`). Plots need
matplotlib and are drawn only with ``plot``.
"""
from __future__ import annotations

import argparse
import inspect


def cli(main, argv=None):
    """Run ``main`` with its keyword arguments from the command line: an
    option ``--name`` a keyword, of its default's type (a flag for a
    bool)."""
    ap = argparse.ArgumentParser(description=inspect.getmodule(main).__doc__)
    for name, p in inspect.signature(main).parameters.items():
        if isinstance(p.default, bool):
            ap.add_argument(f"--{name}", action="store_true")
        else:
            ap.add_argument(f"--{name}", type=type(p.default), default=p.default)
    return main(**vars(ap.parse_args(argv)))


def settings_of(maxiter: int, th_stop: float):
    """The preset's settings (None) unless ``maxiter`` is given (> 0)."""
    from ..solvers.ddp import SolverSettings

    return SolverSettings(maxiter=maxiter, th_stop=th_stop) if maxiter > 0 else None
