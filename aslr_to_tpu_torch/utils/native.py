"""ctypes bindings to the native C++ rigid-body oracle.

PyTorch counterpart of ``aslr_to_tpu/utils/native.py``: ``rnea``,
``mass_matrix`` and ``fk`` of ``native/rbd_oracle.cpp``, an independently
written implementation of the same algorithms (the role Pinocchio's C++
plays for the reference's tests), over the port's :class:`RobotModel`.

At first use ``g++`` builds the source into ``build/aslr_to_tpu_torch/``
beside the package (git-ignored), under a name that hashes the source and
flags, so an edit rebuilds; ``native/`` itself is only read. Inputs are
tensors or arrays ``[..., nv]``; each configuration is one call of the
oracle, and the results are float64 CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[2] / "native" / "rbd_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aslr_to_tpu_torch"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librbd_oracle_{h.hexdigest()[:16]}.so"


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rbd_rnea.argtypes = [ctypes.c_int] + [dp] * 10 + [ctypes.c_int, dp]
    lib.rbd_mass_matrix.argtypes = [ctypes.c_int] + [dp] * 8 + [dp]
    lib.rbd_fk.argtypes = [ctypes.c_int] + [dp] * 4 + [dp, dp]
    _LIB = lib
    return lib


def _f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _model_arrays(model):
    return [_f64(getattr(model, f)) for f in
            ("joint_rot", "joint_pos", "axis", "mass", "com", "inertia", "gravity")]


def _per_config(n_in, out_shape, call, *args):
    """Run ``call(out, *one configuration of each arg)`` for every
    configuration of ``args`` ``[..., n_in]``; returns ``[..., *out_shape]``."""
    arrs = [_f64(a) for a in args]
    lead = np.broadcast_shapes(*(a.shape[:-1] for a in arrs))
    flat = [np.broadcast_to(a, lead + (n_in,)).reshape(-1, n_in) for a in arrs]
    out = np.zeros((flat[0].shape[0],) + out_shape)
    for i in range(out.shape[0]):
        call(out[i], *(np.ascontiguousarray(f[i]) for f in flat))
    return torch.from_numpy(out.reshape(lead + out_shape))


def rnea(model, q, v, a, gravity: bool = True):
    """Joint torques ``[..., nj]`` of the inverse dynamics at (q, v, a)."""
    lib = _load()
    m = _model_arrays(model)
    nj = len(model.parents)

    def call(tau, q_, v_, a_):
        lib.rbd_rnea(nj, *map(_ptr, m), _ptr(q_), _ptr(v_), _ptr(a_), 1 if gravity else 0,
                     _ptr(tau))

    return _per_config(nj, (nj,), call, q, v, a)


def mass_matrix(model, q):
    """The joint-space inertia matrix ``[..., nj, nj]``, symmetrized."""
    lib = _load()
    m = _model_arrays(model)
    nj = len(model.parents)

    def call(M, q_):
        lib.rbd_mass_matrix(nj, *map(_ptr, m), _ptr(q_), _ptr(M))

    M = _per_config(nj, (nj, nj), call, q)
    return 0.5 * (M + M.transpose(-1, -2))


def fk(model, q):
    """World placements of the joint frames: (rots ``[..., nj, 3, 3]``,
    trans ``[..., nj, 3]``)."""
    lib = _load()
    jr, jp, ax = _model_arrays(model)[:3]
    nj = len(model.parents)

    def call(out, q_):
        rots, trans = np.zeros((nj, 3, 3)), np.zeros((nj, 3))
        lib.rbd_fk(nj, _ptr(jr), _ptr(jp), _ptr(ax), _ptr(q_), _ptr(rots), _ptr(trans))
        out[:, :9] = rots.reshape(nj, 9)
        out[:, 9:] = trans

    both = _per_config(nj, (nj, 12), call, q)
    return both[..., :9].reshape(both.shape[:-1] + (3, 3)), both[..., 9:]
