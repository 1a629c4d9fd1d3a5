"""Build, load and count the port's CUDA kernels.

The sources ``aslr_to_tpu_torch/csrc/*.cu`` have a plain C interface. At
first use, one ``nvcc`` per source, all started together, compiles them for
``sm_90a``, and a last ``nvcc`` links the objects into one shared library
under ``build/aslr_to_tpu_torch/`` beside the package (git-ignored), named
by a hash of the sources and flags so that an edit rebuilds; ``ctypes``
loads it. Pointers and the stream pass as ``c_void_p``, integers as
``c_int``; every entry returns ``cudaGetLastError()`` of its launch, and
:func:`check` raises when it is not 0.

``LAUNCHES`` holds one plain integer per kernel, raised by the wrapper
each time it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aslr_to_tpu_torch"
# -fmad=false: no contraction of a*b+c into one rounding, so the kernels
# perform the same IEEE operations as their plain versions; an unstable
# rollout then departs from its plain twin by no more than rounding does.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"linearize": 0, "riccati_box": 0, "rollout2": 0, "riccati_fddp": 0,
            "riccati_boxfddp": 0, "rollout1": 0, "probe": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # params, nl, xs, us, wterm, T, B, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext,
    # cost, ok, tLx, tLxx, tcost, tok, stream
    "aslr_linearize": [_P, _I, _P, _P, _P, _I, _I] + [_P] * 14 + [_P],
    # ndx, nu, gaps, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev,
    # lb, ub, reg, T, B, qp_iters, k, K, w, dg, dq, stop, dg_gap, dq_gap, ok,
    # retryable, stream
    "aslr_riccati_box": [_I, _I, _I] + [_P] * 15 + [_I, _I, _I] + [_P] * 10 + [_P],
    # params, nl, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub, fs,
    # infeas, T, B, xs_a, us_a, cost_a, xs_b, us_b, cost_b, stream
    "aslr_rollout2": [_P, _I] + [_P] * 12 + [_I, _I] + [_P] * 6 + [_P],
    # ndx, nu, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg, T, B, k, K,
    # w, dg, dq, stop, dg_gap, dq_gap, ok, retryable, stream
    "aslr_riccati_fddp": [_I, _I] + [_P] * 11 + [_I, _I] + [_P] * 10 + [_P],
    # params, nl, xs, us, k, K, x0, alpha, wterm, lb, ub, fs, infeas, T, B,
    # xs_o, us_o, cost_o, stream
    "aslr_rollout1": [_P, _I] + [_P] * 11 + [_I, _I] + [_P] * 3 + [_P],
    # x, out, n, ilp, fma, steps, loop, stream (float32 only)
    "aslr_probe": [_P, _P, _I, _I, _I, _I, _I, _P],
    # nu, gaps, itemsize: the box kernel's dynamic shared memory a block
    "aslr_riccati_box_smem": [_I, _I, _I],
    # ntrials, sea, gaps, itemsize: the rollout's dynamic shared memory a block
    "aslr_rollout_smem": [_I, _I, _I, _I],
}
_SUFFIXES = {"aslr_probe": ("_f32",), "aslr_riccati_box_smem": ("",),
             "aslr_rollout_smem": ("",)}

_lib = None
build_log = ""


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libaslr_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Each source compiles in its own ``nvcc`` process, all
    at once; the compilers' output (``-Xptxas -v``: registers, spills) is
    kept in ``build_log``."""
    global build_log
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cu, obj in zip(cus, objs)]
        logs, failed = [], []
        for cu, proc in zip(cus, procs):
            text, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{cu.name} ({proc.returncode})")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return out


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for base, argtypes in _SIGNATURES.items():
            for suffix in _SUFFIXES.get(base, ("_f32", "_f64")):
                fn = getattr(handle, base + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def entry(base: str, dtype):
    """The C entry of ``base`` for a float32 or float64 tensor dtype."""
    import torch

    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    allowed = _SUFFIXES.get(base, ("_f32", "_f64"))
    if suffix not in allowed:
        names = " or ".join({"_f32": "float32", "_f64": "float64"}[a] for a in allowed)
        raise TypeError(f"{base}: {names} tensors only, got {dtype}")
    return getattr(lib(), base + suffix)


def check(name: str, code: int):
    """Raise unless a launch returned cudaSuccess; count it otherwise."""
    if code == -1:
        raise NotImplementedError(f"{name}: no kernel instantiated for this shape")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
    LAUNCHES[name] += 1


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
