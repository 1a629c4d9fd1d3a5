"""Trajectory save and load: ``.npz`` archives and the ``.mat`` export.

PyTorch counterpart of ``aslr_to_tpu/utils/io.py``: round-trippable
solution archives (a warm start for a later re-solve) and the reference's
``scipy.io.savemat`` export (``examples/two_dof_vsa_boxddp.py:125-127``).
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_solution(path: str, xs, us, dt: float = None, extra: dict = None):
    """Save a solved trajectory (``xs``, ``us``, tensors or arrays) and
    ``extra`` entries to an ``.npz``."""
    data = dict(xs=_np(xs), us=_np(us))
    if dt is not None:
        data["dt"] = np.asarray(dt)
    if extra:
        data.update({k: _np(v) for k, v in extra.items()})
    np.savez(path, **data)


def load_solution(path: str, device=None):
    """``(xs, us)`` saved by :func:`save_solution`, as tensors of the saved
    dtype on ``device``."""
    with np.load(path) as f:
        return (torch.as_tensor(f["xs"], device=device), torch.as_tensor(f["us"], device=device))


def export_mat(path: str, xs, us, dt: float):
    """The reference's ``.mat`` export: the time grid ``t``, the link
    angles ``q1 ..`` of the soft state and the controls ``u1 ..`` in one
    file (scipy, imported here)."""
    from scipy.io import savemat

    xs, us = _np(xs), _np(us)
    T = us.shape[0]
    payload = {"t": np.arange(0, T * dt, dt)[:T]}
    nl = xs.shape[1] // 4
    for i in range(nl):
        payload[f"q{i + 1}"] = xs[:T, i]
    for i in range(us.shape[1]):
        payload[f"u{i + 1}"] = us[:, i]
    savemat(path, payload)
