"""The linearization (K1, ``csrc/linearize.cu``) run on the CPU.

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu``: one thread per CUDA thread, and the warp's votes and
shuffles at a barrier over the block (a shuffle whose mask leaves out its
own or its source lane reads NaN). The wrapper, pointed at that library,
is held against its plain version on the VSA and SEA arms at B=1, 15 and
33 (each launch ends in a partial block; T=6, so a block holds the
terminal knot of some scenarios beside the running knots of others), the
terminal knot included. Scenario 7 sits at a goal rotation of pi at
every knot, where ``log3`` takes its branch near pi and its sanitized
tangents.

The kernel performs its plain version's operations in the same order, so
the two agree to the bit, NaNs included, in f64 and f32: the kernel builds
with -ffp-contract=off (and -fno-builtin: sin and cos of one angle stay
two calls), and the plain version runs here with the C library's sin, cos
and atan2 and a correctly rounded square root in place of PyTorch's CPU
kernels, whose vectorized loops round some results differently in the last
bit.
"""
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build, vsa_kernels
from test_torch_rollout_cpu import _ieee_sqrt, _libm

T = 6
PI_SCENARIO = 7
HERE = Path(__file__).resolve().parent
SMEM = """#include "cuda_runtime.h"
namespace aslr { alignas(16) unsigned char lin_smem[cpu_cuda::kSharedBytes]; }
unsigned char* cpu_cuda::shared_memory = aslr::lin_smem;
"""


@pytest.fixture(scope="module")
def lin_lib(tmp_path_factory):
    """linearize.cu built for the CPU; the wrapper launches it on CPU
    tensors, and the plain version takes the C library's transcendentals,
    while the fixture lasts."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("linearize_kernel")
    src = (build.CSRC / "linearize.cu").read_text()
    # kernel<<<grid, block, smem, stream>>>(args) -> cpu_cuda::launch(...)
    src = re.sub(r"(\w+<[^<>;]*>)<<<(.*?)>>>\(", r"::cpu_cuda::launch(\2, \1, ", src)
    (d / "linearize.cpp").write_text(src)
    (d / "smem.cpp").write_text(SMEM)
    lib = d / "liblinearize.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-builtin", "-fPIC",
                    "-shared", "-pthread", f"-I{HERE / 'cuda_on_cpu'}", f"-I{build.CSRC}",
                    "-o", str(lib), str(d / "linearize.cpp"), str(d / "smem.cpp"),
                    str(HERE / "cuda_on_cpu" / "runtime.cpp")], check=True)
    handle = ctypes.CDLL(str(lib))
    for suffix in ("_f32", "_f64"):
        fn = getattr(handle, "aslr_linearize" + suffix)
        fn.argtypes = build._SIGNATURES["aslr_linearize"]
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


def _args(arm, B, dtype, seed=0):
    """(spec, xs, us, wterm): random states and controls (the VSA's
    stiffnesses positive), a terminal weight that differs by lane, and
    scenario 7 (where B allows) at q_l = (pi, 0) at every knot."""
    rng = np.random.default_rng(seed)
    if arm == "sea":
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device="cpu").problem,
                                            None)
        us = 3.0 * rng.standard_normal((T, 2, B))
    else:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cpu")
        spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
        us = np.concatenate([3.0 * rng.standard_normal((T, 2, B)),
                             2.0 * np.abs(rng.standard_normal((T, 2, B)))], axis=1)
    xs = 0.3 * rng.standard_normal((T + 1, 8, B))
    if B > PI_SCENARIO:
        xs[:, 0, PI_SCENARIO], xs[:, 1, PI_SCENARIO] = math.pi, 0.0
    wterm = spec.w_goal_term * (1.0 + np.arange(B) % 3)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    return spec, t(xs), t(us), t(wterm)


def _flat(lin):
    return ([lin.cost, lin.xnext, lin.ok] + [lin.run[k] for k in sorted(lin.run)]
            + [lin.term[k] for k in sorted(lin.term)])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 33])
@pytest.mark.parametrize("arm", ["vsa", "sea"])
def test_linearize_on_cpu_matches_plain_version(lin_lib, arm, batch, dtype):
    args = _args(arm, batch, dtype)
    before = build.LAUNCHES["linearize"]
    got = vsa_kernels.linearize(*args)
    assert build.LAUNCHES["linearize"] == before + 1
    want = vsa_kernels.linearize_plain(*args)
    names = ["cost", "xnext", "ok"] + [f"run.{k}" for k in sorted(want.run)] + \
        [f"term.{k}" for k in sorted(want.term)]
    for name, g, w in zip(names, _flat(got), _flat(want)):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name
    assert bool(got.ok.all())
    if batch > PI_SCENARIO:     # the goal Jacobian at pi is finite and not zero
        J = got.term["Lxx"][:2, :2, PI_SCENARIO]
        assert bool(torch.isfinite(J).all()) and bool((J != 0).any())


def test_linearize_on_cpu_keeps_a_scenario_in_its_group(lin_lib):
    """Scenario 9's states at knot 0 NaN: its flag falls alone; the
    scenarios beside it in its warp (knot 0 of scenarios 8 and 10-15) keep
    theirs and equal the plain version."""
    spec, xs, us, wterm = _args("vsa", 33, torch.float64)
    xs = xs.clone()
    xs[0, :, 9] = float("nan")
    got = vsa_kernels.linearize(spec, xs, us, wterm)
    want = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))
    assert not bool(got.ok[9]) and bool(got.ok[[8, 10, 11, 12, 13, 14, 15]].all())
