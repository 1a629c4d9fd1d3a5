"""The port's CUDA sources built with g++ for the CPU, for the tests.

``gxx_library`` compiles sources of ``aslr_to_tpu_torch/csrc`` against the
stand-in headers beside this file (``cuda_runtime.h``, ``cuda_pipeline.h``,
``runtime.cpp``: one thread per CUDA thread, __syncthreads at a barrier
over the block, the warp primitives at one over the warp). ``libm`` and ``ieee_sqrt`` give the plain
versions the C library's transcendentals and a correctly rounded square
root, so that they match the kernels so built to the bit.
"""
import ctypes
import ctypes.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch.kernels import build

HERE = Path(__file__).resolve().parent
SMEM = """#include "cuda_runtime.h"
namespace aslr { alignas(16) unsigned char roll_smem[cpu_cuda::kSharedBytes]; }
unsigned char* cpu_cuda::shared_memory = aslr::roll_smem;
"""


def libm(name, nargs):
    """``name`` of the C library as a function of tensors, for f64 (``name``)
    and f32 (``name`` + f)."""
    clib = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = {}
    for dtype, suffix, ctype in ((torch.float64, "", ctypes.c_double),
                                 (torch.float32, "f", ctypes.c_float)):
        fn = getattr(clib, name + suffix)
        fn.restype, fn.argtypes = ctype, [ctype] * nargs
        fns[dtype] = np.frompyfunc(fn, nargs, 1)

    def call(*args):
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        out = fns[dtype](*(torch.as_tensor(a, dtype=dtype).numpy() for a in args))
        return torch.from_numpy(np.asarray(out, dtype=torch.empty(0, dtype=dtype).numpy().dtype))

    return call


def ieee_sqrt(x):
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def gxx_library(d, sources, smem_name, bases):
    """The CUDA ``sources`` (names in ``csrc``) built with g++ for the CPU
    into a library under the directory ``d``, loaded, with the argument
    types of the C entries of ``bases`` (at every chain length built) set.
    Every source and header is copied with each
    ``kernel<<<grid, block, smem, stream>>>(args)`` rewritten into
    ``cpu_cuda::launch(grid, block, smem, stream, kernel, args)``;
    ``smem_name`` is the kernels' dynamic shared memory array. -fno-builtin
    keeps sin and cos of one angle two calls of the C library (the plain
    version's), not one sincos."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    src_dir = d / "csrc"
    src_dir.mkdir()
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        text = re.sub(r"(\w+<[^<>;]*>)<<<(.*?)>>>\(", r"::cpu_cuda::launch(\2, \1, ",
                      f.read_text())
        (src_dir / (f.stem + (".cpp" if f.suffix == ".cu" else f.suffix))).write_text(text)
    (d / "smem.cpp").write_text(SMEM.replace("roll_smem", smem_name))
    lib = d / "libkernels.so"
    subprocess.run([gxx, "-std=c++20", "-O0", "-ffp-contract=off", "-fno-builtin", "-fPIC",
                    "-shared", f"-I{HERE}", f"-I{src_dir}",
                    "-o", str(lib), *(str(src_dir / (Path(f).stem + ".cpp")) for f in sources),
                    str(d / "smem.cpp"), str(HERE / "runtime.cpp")], check=True)
    handle = ctypes.CDLL(str(lib))
    for base in bases:
        for name in [base] + [f"{base}_n{nl}" for nl in build.chains(base)]:
            for suffix in build._SUFFIXES.get(base, ("_f32", "_f64")):
                fn = getattr(handle, name + suffix)
                fn.argtypes = build._SIGNATURES[base]
                fn.restype = ctypes.c_int
    return handle
