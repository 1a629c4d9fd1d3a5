"""Build, load and count the port's CUDA kernels.

The sources ``aslr_to_tpu_torch/csrc/*.cu`` have a plain C interface; the
kernels' templates sit in ``csrc/*.cuh``, and a kernel built at several
chain lengths has a source per length (``linearize.cu`` at nl = 2,
``linearize_n3.cu`` and ``linearize_n7.cu`` at 3 and 7, each with its own C
entries, ``aslr_linearize_n7_f32`` and so on; the rollouts' instances that
take a per-knot problem's tables sit in ``rollout*_tables.cu``, with entries
``aslr_rollout2_tables_f32`` and so on). At first use, one ``nvcc``
per source, all started together, compiles them for ``sm_90a``, and a last
``nvcc`` links the objects into one shared library under
``build/aslr_to_tpu_torch/`` beside the package (git-ignored), named by a
hash of the sources and flags so that an edit rebuilds; ``ctypes`` loads
it. Pointers and the stream pass as ``c_void_p``, integers as
``c_int``; every entry returns ``cudaGetLastError()`` of its launch, and
:func:`check` raises when it is not 0.

``LAUNCHES`` holds one plain integer per kernel, raised by the wrapper
each time it launches its kernel and nowhere else. ``INSTANCES`` lists the
shapes and variants each kernel is built for; a wrapper asked for another
raises (:func:`require`) and names them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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

# what each kernel is built for: K1 at nl (chain length) and actuation; K3
# and K6 at nl, actuation, box ("box": a box a lane; "box tables": [T, nu]
# tables) and gaps; the Riccati group kernel at (ndx, nu), K2 and K5 also
# with box tables. Above nl = 2 the SEA arm's rollouts of the JAX package's
# n-DoF kernel routes: FDDP's (gaps), DDP's (neither) and BoxFDDP's (box and
# gaps), and K5 at (12, 3) and (28, 7); not BoxDDP's (K2 and a box without
# gaps, which the JAX package's n-DoF lane route cannot take) and no box
# tables.
_ROLLOUT_INSTANCES = tuple(
    f"nl=2 {arm}{box}{gaps}" for arm in ("vsa", "sea") for box in ("", " box", " box tables")
    for gaps in ("", " gaps")) + tuple(
    f"nl={nl} sea{v}" for nl in (3, 7) for v in (" gaps", "", " box gaps"))
INSTANCES = {
    "linearize": ("nl=2 vsa", "nl=2 sea", "nl=3 sea", "nl=7 sea"),
    "rollout2": _ROLLOUT_INSTANCES,
    "rollout1": _ROLLOUT_INSTANCES,
    "riccati_box": ("ndx=8 nu=4", "ndx=8 nu=4 box tables"),
    "riccati_boxfddp": ("ndx=8 nu=2", "ndx=8 nu=4", "ndx=8 nu=2 box tables",
                        "ndx=8 nu=4 box tables", "ndx=12 nu=3", "ndx=28 nu=7"),
    "riccati_fddp": ("ndx=8 nu=2", "ndx=8 nu=4", "ndx=12 nu=3", "ndx=28 nu=7"),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # params, nl, xs, us, wterm, tgt, T, B, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu,
    # xnext, cost, ok, tLx, tLxx, tcost, tok, stream (tgt: the [T, 12] target
    # table or null, as every table below)
    "aslr_linearize": [_P, _I, _P, _P, _P, _P, _I, _I] + [_P] * 14 + [_P],
    # ndx, nu, gaps, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev,
    # lb, ub, lb_table, ub_table, reg, T, B, qp_iters, k, K, w, dg, dq, stop,
    # dg_gap, dq_gap, ok, retryable, stream
    "aslr_riccati_box": [_I, _I, _I] + [_P] * 17 + [_I, _I, _I] + [_P] * 10 + [_P],
    # params, nl, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub, lb_table,
    # ub_table, fs, infeas, tgt, T, B, xs_a, us_a, cost_a, xs_b, us_b, cost_b,
    # stream
    "aslr_rollout2": [_P, _I] + [_P] * 15 + [_I, _I] + [_P] * 6 + [_P],
    # ndx, nu, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg, T, B, k, K,
    # w, dg, dq, stop, dg_gap, dq_gap, ok, retryable, stream
    "aslr_riccati_fddp": [_I, _I] + [_P] * 11 + [_I, _I] + [_P] * 10 + [_P],
    # params, nl, xs, us, k, K, x0, alpha, wterm, lb, ub, lb_table, ub_table,
    # fs, infeas, tgt, T, B, xs_o, us_o, cost_o, stream
    "aslr_rollout1": [_P, _I] + [_P] * 14 + [_I, _I] + [_P] * 3 + [_P],
    # K3 and K6 with the per-knot tables (csrc/rollout*_tables.cu): their
    # instances of their own, the same arguments
    "aslr_rollout2_tables": [_P, _I] + [_P] * 15 + [_I, _I] + [_P] * 6 + [_P],
    "aslr_rollout1_tables": [_P, _I] + [_P] * 14 + [_I, _I] + [_P] * 3 + [_P],
    # x, out, n, ilp, fma, steps, loop, stream (float32 only)
    "aslr_probe": [_P, _P, _I, _I, _I, _I, _I, _P],
    # ndx, nu, gaps, itemsize: the box kernel's dynamic shared memory a block
    "aslr_riccati_box_smem": [_I, _I, _I, _I],
    # ndx, nu, itemsize: K4's dynamic shared memory a block
    "aslr_riccati_fddp_smem": [_I, _I, _I],
    # nl, ntrials, sea, gaps, wide (K3's layout), itemsize: the rollout's
    # dynamic shared memory a block
    "aslr_rollout_smem": [_I, _I, _I, _I, _I, _I],
    # the launch of K4 and K5 at (28, 7), of K3 / K6 and of K1 at nl 7 at a
    # batch: itemsize, B, out (K3 / K6: ntrials, box and gaps first; K1: T
    # before B); out[0 .. 4) = grid, threads a block, dynamic shared memory,
    # blocks resident an SM, and for K3 / K6 out[4] the layout (1 wide)
    "aslr_riccati_fddp_n7_launch": [_I, _I, _P],
    "aslr_riccati_boxfddp_n7_launch": [_I, _I, _P],
    "aslr_rollout_n7_launch": [_I, _I, _I, _I, _I, _P],
    "aslr_linearize_n7_launch": [_I, _I, _I, _P],
}
_SUFFIXES = {"aslr_probe": ("_f32",), "aslr_riccati_box_smem": ("",),
             "aslr_riccati_fddp_smem": ("",), "aslr_rollout_smem": ("",),
             "aslr_riccati_fddp_n7_launch": ("",), "aslr_riccati_boxfddp_n7_launch": ("",),
             "aslr_rollout_n7_launch": ("",), "aslr_linearize_n7_launch": ("",)}

_lib = None
build_log = ""
build_seconds = {}      # each source's nvcc time in the last build


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chains(base: str) -> list[int]:
    """The chain lengths above 2 at which the C entry ``base`` (e.g.
    "aslr_linearize") is built, from ``INSTANCES``: each has a source of its
    own and entries ``<base>_n<nl>_f32`` and ``_f64``."""
    kernel = base.removeprefix("aslr_").removesuffix("_tables")
    return sorted({int(i.split()[0][3:]) for i in INSTANCES.get(kernel, ())
                   if i.startswith("nl=")} - {2})


def require(name: str, instance: str):
    """Raise unless kernel ``name`` is built for ``instance`` (a key of
    ``INSTANCES``, e.g. "nl=7 sea" or "ndx=28 nu=7"), naming what it is
    built for."""
    if instance not in INSTANCES[name]:
        raise NotImplementedError(f"{name}: no kernel instance for {instance}; its instances: "
                                  f"{', '.join(INSTANCES[name])}")


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
    kept in ``build_log``, and each one's seconds in ``build_seconds``."""
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
        def compile_one(cu, obj):
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return proc, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=len(cus)) as pool:
            done = list(pool.map(compile_one, cus, objs))
        logs, failed = [], []
        build_seconds.clear()
        for cu, (proc, seconds) in zip(cus, done):
            build_seconds[cu.name] = seconds
            logs.append(f"== {cu.name} ({seconds:.1f} s)\n{proc.stdout}")
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
            for name in [base] + [f"{base}_n{nl}" for nl in chains(base)]:
                for suffix in _SUFFIXES.get(base, ("_f32", "_f64")):
                    fn = getattr(handle, name + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def entry(base: str, dtype, nl: int = 2):
    """The C entry of ``base`` for a float32 or float64 tensor dtype, at the
    chain length ``nl`` where the kernel has one source per length (a
    wrapper checks the instance first, with :func:`require`)."""
    import torch

    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    allowed = _SUFFIXES.get(base, ("_f32", "_f64"))
    if suffix not in allowed:
        names = " or ".join({"_f32": "float32", "_f64": "float64"}[a] for a in allowed)
        raise TypeError(f"{base}: {names} tensors only, got {dtype}")
    return getattr(lib(), base + ("" if nl == 2 else f"_n{nl}") + suffix)


def check(name: str, code: int, instance: str = ""):
    """Raise unless a launch returned cudaSuccess; count it otherwise.
    ``instance`` names the shape asked for (a key of ``INSTANCES``)."""
    if code == -1:
        raise NotImplementedError(f"{name}: the launcher has no instance for "
                                  f"{instance or 'this shape'}; its instances: "
                                  f"{', '.join(INSTANCES.get(name, ()))}")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
    LAUNCHES[name] += 1


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def launch_of(kernel: str, dtype, B: int, T: int = 100, variant: str = "sea gaps") -> dict:
    """The launch of K4 or K5 at (28, 7) ("riccati_fddp", "riccati_boxfddp"),
    of K3 / K6 at nl 7 ("rollout2", "rollout1"; ``variant`` "sea gaps",
    "sea" or "sea box gaps") or of K1 at nl 7 over T knots ("linearize")
    for a float32 or float64 batch of B: grid, threads a block, dynamic
    shared memory in bytes and the blocks the card keeps resident an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for K3 / K6 also the
    layout that the launch takes at B ("wide" or "general")."""
    import torch

    size = torch.empty(0, dtype=dtype).element_size()
    out = (ctypes.c_int * 5)()
    if kernel in ("riccati_fddp", "riccati_boxfddp"):
        code = getattr(lib(), f"aslr_{kernel}_n7_launch")(size, B, out)
    elif kernel == "linearize":
        code = lib().aslr_linearize_n7_launch(size, T, B, out)
    else:
        require(kernel, f"nl=7 {variant}")
        code = lib().aslr_rollout_n7_launch({"rollout1": 1, "rollout2": 2}[kernel],
                                            int("box" in variant), int("gaps" in variant), size,
                                            B, out)
    if code != 0:
        raise RuntimeError(f"{kernel}: the launch query failed with error {code}")
    info = dict(grid=out[0], threads=out[1], smem=out[2], blocks_per_sm=out[3])
    if kernel.startswith("rollout"):
        info["layout"] = "wide" if out[4] else "general"
    return info


def stream_of(t):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
