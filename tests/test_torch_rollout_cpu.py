"""The rollouts (K3 and K6, ``csrc/rollout.cu``) run on the CPU.

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu``: one thread per CUDA thread, the block and warp
primitives at a barrier over the block (a shuffle whose mask leaves out its
own or its source lane reads NaN), cp.async as a copy, and shared memory
refilled with NaN bytes before each block, so an unstaged read shows. The
wrappers, pointed at that library, are held against their plain versions
on ragged batches: B=1, 15 and 33 take the one-element copies, B=40 the
16-byte ones, and each ends in a partial block (32 trajectories a block for
K6, 16 scenarios of two trials for K3). T=6 is not a multiple of the four
lanes of a group, so the running costs deferred to the group meet a ragged
tail. Cases: the VSA arm in its box, the VSA arm with gaps in a tight box,
and the SEA arm with gaps, unbounded; step lengths 1 and below 1, and
infeasible lanes among feasible ones.

The kernel performs its plain version's operations in the same order, so
the two agree to the bit, NaNs included, in f64 and f32: the kernel builds
with -ffp-contract=off, and the plain versions run here with the C
library's sin, cos and atan2 (and a correctly rounded square root) in place
of PyTorch's CPU kernels, whose vectorized loops round some results
differently in the last bit.
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

from aslr_to_tpu_torch import Bounds, two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build, vsa_kernels

T = 6
HERE = Path(__file__).resolve().parent
SMEM = """#include "cuda_runtime.h"
namespace aslr { alignas(16) unsigned char roll_smem[cpu_cuda::kSharedBytes]; }
unsigned char* cpu_cuda::shared_memory = aslr::roll_smem;
"""
VARIANTS = ("vsa_box", "vsa_box_gaps", "sea_gaps")
DTYPES = dict(argnames="dtype", argvalues=[torch.float64, torch.float32], ids=["f64", "f32"])


def _libm(name, nargs):
    """``name`` of the C library as a function of tensors, for f64 (``name``)
    and f32 (``name`` + f)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = {}
    for dtype, suffix, ctype in ((torch.float64, "", ctypes.c_double),
                                 (torch.float32, "f", ctypes.c_float)):
        fn = getattr(libm, name + suffix)
        fn.restype, fn.argtypes = ctype, [ctype] * nargs
        fns[dtype] = np.frompyfunc(fn, nargs, 1)

    def call(*args):
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        out = fns[dtype](*(torch.as_tensor(a, dtype=dtype).numpy() for a in args))
        return torch.from_numpy(np.asarray(out, dtype=torch.empty(0, dtype=dtype).numpy().dtype))

    return call


def _ieee_sqrt(x):
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.numpy()))


@pytest.fixture(scope="module")
def roll_lib(tmp_path_factory):
    """rollout.cu built for the CPU; the wrappers launch it on CPU tensors,
    and the plain versions take the C library's transcendentals, while the
    fixture lasts."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("rollout_kernel")
    src = (build.CSRC / "rollout.cu").read_text()
    # kernel<<<grid, block, smem, stream>>>(args) -> cpu_cuda::launch(...)
    src = re.sub(r"(\w+<[^<>;]*>)<<<(.*?)>>>\(", r"::cpu_cuda::launch(\2, \1, ", src)
    (d / "rollout.cpp").write_text(src)
    (d / "smem.cpp").write_text(SMEM)
    lib = d / "librollout.so"
    # -fno-builtin: sin and cos of one angle stay two calls of the C library
    # (the plain version's), not one sincos
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-builtin", "-fPIC",
                    "-shared", "-pthread", f"-I{HERE / 'cuda_on_cpu'}", f"-I{build.CSRC}",
                    "-o", str(lib), str(d / "rollout.cpp"), str(d / "smem.cpp"),
                    str(HERE / "cuda_on_cpu" / "runtime.cpp")], check=True)
    handle = ctypes.CDLL(str(lib))
    for base in ("aslr_rollout2", "aslr_rollout1"):
        for suffix in ("_f32", "_f64"):
            fn = getattr(handle, base + suffix)
            fn.argtypes = build._SIGNATURES[base]
            fn.restype = ctypes.c_int
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "_lib", handle)
    mp.setattr(vsa_kernels, "_route", lambda t: "kernel")
    mp.setattr(build, "stream_of", lambda t: None)
    mp.setattr(torch, "sqrt", _ieee_sqrt)
    mp.setattr(torch, "sin", _libm("sin", 1))
    mp.setattr(torch, "cos", _libm("cos", 1))
    mp.setattr(torch, "atan2", _libm("atan2", 2))
    yield handle
    mp.undo()


def _args(variant, B, dtype, seed=0):
    """K3's arguments (spec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb,
    ub, fs, infeas): a random reference trajectory and gains; alpha_a 1 and
    alpha_b 1/2, 1/4, 1/8 by lane; lanes 0, 3, 6, ... infeasible."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    if variant == "sea_gaps":
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device="cpu").problem,
                                            None)
        scale = np.array([3.0, 3.0])
    else:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cpu")
        # with gaps, the tight box of tests/test_torch_rollout.py: in the
        # preset's wide one the stiff motor side soon makes the rollout chaotic
        bounds = (w.bounds if variant == "vsa_box" else
                  Bounds(t([-2.0, -2.0, 0.0, 0.0]), t([2.0, 2.0, 3.0, 3.0])))
        spec = vsa_kernels.extract_vsa_spec(w.problem, bounds)
        scale = np.array([3.0, 3.0, 2.0, 2.0])
    nu = scale.size
    xs = 0.1 * rng.standard_normal((T + 1, 8, B))
    us = rng.standard_normal((T, nu, B)) * scale[:, None]
    k = 0.5 * rng.standard_normal((T, nu, B))
    if nu == 4:     # stiffness steps that push the stiffness below the box's 0
        us[:, 2:] = np.abs(us[:, 2:])
        k[:, 2:] = us[:, 2:] + 3.0 * np.abs(rng.standard_normal((T, 2, B)))
    K = 0.1 * rng.standard_normal((T, nu, 8, B))
    x0 = xs[0] + 0.01 * rng.standard_normal((8, B))
    box = [None, None]
    if spec.lb is not None:
        box = [t(np.repeat(np.asarray(b, dtype=float)[:, None], B, axis=1))
               for b in (spec.lb, spec.ub)]
    gaps = [None, None]
    if variant.endswith("gaps"):
        gaps = [t(0.05 * rng.standard_normal((T + 1, 8, B))), t(np.arange(B) % 3 == 0)]
    return (spec, t(xs), t(us), t(k), t(K), t(x0), t(np.ones(B)),
            t(0.5 ** (1 + np.arange(B) % 3)), torch.full((B,), spec.w_goal_term, dtype=dtype),
            *box, *gaps)


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


def _k6_args(args):
    """K6's arguments: K3's with the second trial's step lengths."""
    return args[:6] + args[7:]


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 33, 40])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rollout2_on_cpu_matches_plain_version(roll_lib, variant, batch, dtype):
    args = _args(variant, batch, dtype)
    before = build.LAUNCHES["rollout2"]
    got = vsa_kernels.rollout2(*args)
    assert build.LAUNCHES["rollout2"] == before + 1
    want = vsa_kernels.rollout2_plain(*args)
    for g, w in zip(got, want):
        _assert_same_bits(g, w)
    # most lanes stay finite, and the trials differ
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    assert not torch.equal(got[0].us, got[1].us)
    if variant == "vsa_box":        # some controls sit on the box
        on = (got[1].us == args[9][None]) | (got[1].us == args[10][None])
        assert bool(on.any())


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 33, 40])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rollout1_on_cpu_matches_plain_and_first_trial(roll_lib, variant, batch, dtype):
    """K6 at alpha equals its plain version, and K3's first trial at alpha
    to the bit (the same trajectory code)."""
    args = _k6_args(_args(variant, batch, dtype))
    before = build.LAUNCHES["rollout1"]
    got = vsa_kernels.rollout1(*args)
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same_bits(got, vsa_kernels.rollout1_plain(*args))
    first, _ = vsa_kernels.rollout2(*args[:7], 0.5 * args[6], *args[7:])
    _assert_same_bits(got, first)


@pytest.mark.parametrize("kernel", ["rollout2", "rollout1"])
def test_rollout_on_cpu_keeps_a_trajectory_in_its_group(roll_lib, kernel):
    """Scenario 25's gains NaN: its trajectory fails alone; the other
    trajectories of its warp (24-31) stay finite and equal the plain
    version."""
    args = list(_args("vsa_box", 40, torch.float64))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    if kernel == "rollout1":
        args = _k6_args(args)
    got = getattr(vsa_kernels, kernel)(*args)
    want = getattr(vsa_kernels, kernel + "_plain")(*args)
    for g, w in zip(got, want) if kernel == "rollout2" else [(got, want)]:
        _assert_same_bits(g, w)
        assert bool(g.cost[25].isnan())
        assert bool(torch.isfinite(g.cost[[24, 26, 27, 28, 29, 30, 31]]).all())
