"""Carry a workload's constants across from the JAX package, numpy only.

The JAX package's ``VSASpec`` and ``RobotConsts`` hold numpy arrays and
Python numbers (``aslr_to_tpu/pallas/vsa_kernels.py::VSASpec``,
``aslr_to_tpu/ops/lanes.py::RobotConsts``) and its ``RobotModel`` holds
arrays that ``np.asarray`` reads. These functions turn such fields into the
port's objects. They import no JAX: the caller hands over plain fields
(``spec._asdict()``, ``vars(rc)``, or a dict of arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.vsa_kernels import VSASpec
from .ops.lanes import RobotConsts
from .ops.rigid_body import RobotModel


def _fields(obj):
    return obj if isinstance(obj, dict) else vars(obj)


def _arr(a):
    return None if a is None else np.asarray(a, dtype=np.float64)


def robot_consts_from_numpy(fields) -> RobotConsts:
    """``RobotConsts`` from a dict (or an object) with its numpy fields."""
    f = _fields(fields)
    return RobotConsts(**{name: f[name] for name in RobotConsts.FIELDS})


def spec_from_numpy(fields) -> VSASpec:
    """The port's :class:`VSASpec` from the JAX spec's fields, a per-knot
    spec's ``[T, 3, 3]`` target and ``[T, nu]`` box included (each array
    keeps its shape; ``workloads/presets.py::with_frame_targets`` builds the
    matching port problem from the JAX problem's stacked target leaves as
    numpy). The spec's constants stay float64 numpy: the kernels take them
    by value in their parameter block, and the plain versions as Python
    floats, whatever the dtype and device of the tensors they run on."""
    f = dict(_fields(fields))
    out = {}
    for name in VSASpec._fields:
        val = f.get(name, VSASpec._field_defaults.get(name))
        if name == "rc":
            val = robot_consts_from_numpy(val)
        elif name in ("dt", "w_goal", "w_goal_term", "stiff_w"):
            val = float(val)
        elif name in ("frame_id", "nu", "nl"):
            val = int(val)
        elif name != "variant":
            val = _arr(val)
        out[name] = val
    return VSASpec(**out)


def robot_from_numpy(fields, dtype=torch.float64, device=None) -> RobotModel:
    """A :class:`RobotModel` on ``device`` in ``dtype`` from the fields of
    the JAX package's ``RobotModel`` (numpy arrays or anything
    ``np.asarray`` reads, plus its static topology)."""
    f = _fields(fields)

    def t(name):
        return torch.as_tensor(np.array(f[name], dtype=np.float64), dtype=dtype, device=device)

    return RobotModel(
        name=str(f["name"]),
        parents=tuple(int(p) for p in f["parents"]),
        frame_names=tuple(f["frame_names"]),
        frame_parents=tuple(int(p) for p in f["frame_parents"]),
        **{name: t(name) for name in ("joint_rot", "joint_pos", "axis", "mass", "com",
                                      "inertia", "frame_rot", "frame_pos", "gravity")},
    )


def stages_from_numpy(scales, ub_stages, dtype=torch.float64, device=None):
    """A homotopy schedule (``stiffness_continuation``'s or
    ``rescue_continuation``'s ``(scales, ub_stages)``) from numpy values:
    the scales as a tuple of floats, ``ub_stages [n_stages, nu]`` as a
    tensor on ``device`` in ``dtype`` (None stays None)."""
    ub = None if ub_stages is None else torch.as_tensor(
        np.array(ub_stages, dtype=np.float64), dtype=dtype, device=device)
    return tuple(float(s) for s in np.asarray(scales, dtype=np.float64)), ub
