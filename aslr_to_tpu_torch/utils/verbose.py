"""The per-iteration table of a solve, after the fact (Crocoddyl's
``CallbackVerbose`` columns).

PyTorch counterpart of ``aslr_to_tpu/utils/verbose.py``: the reference
attaches ``crocoddyl.CallbackVerbose`` to every example solve
(``examples/two_dof_sea.py:75``); here :class:`..solvers.ddp.SolveLog`
carries the same fields (``keep_log=True``) and this module renders one
scenario's log in the same text::

    iter     cost         stop         grad         xreg         ureg       step    ||ffeas||

grad = d1 (the expected improvement's linear term), xreg = ureg = the
shared Levenberg-Marquardt regularization, ||ffeas|| = the largest defect
gap.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_HEADER = ("iter     cost         stop         grad         xreg    "
           "     ureg       step    ||ffeas||")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def format_iteration_table(log, iterations=None) -> str:
    """One scenario's :class:`SolveLog` (series ``[maxiter]``) as the table;
    ``iterations`` (``SolveResult.iterations``) truncates it, and rows whose
    cost is NaN (never run) are skipped. '' for an empty log."""
    costs = _np(log.costs)
    if costs.ndim != 1 or costs.size == 0:
        return ""
    n = costs.shape[0] if iterations is None else min(int(iterations), costs.shape[0])
    stops, regs, steps, d1, gaps = (_np(a) for a in (log.stops, log.regs, log.steps, log.d1,
                                                      log.gap_norms))
    lines = [_HEADER]
    for i in range(n):
        if math.isnan(float(costs[i])):
            continue
        lines.append(
            f"{i:4d}  {float(costs[i]):11.5e}  {float(stops[i]):11.5e}  "
            f"{float(d1[i]):11.5e}  {float(regs[i]):11.5e}  {float(regs[i]):11.5e}  "
            f"{float(steps[i]):6.4f}  {float(gaps[i]):11.5e}")
    if len(lines) == 1:
        return ""
    return "\n".join(lines)


def print_iteration_table(log, iterations=None) -> None:
    s = format_iteration_table(log, iterations)
    if s:
        print(s)
