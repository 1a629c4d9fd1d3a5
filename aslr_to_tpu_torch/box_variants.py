"""Time source variants of the group kernel of ``csrc/riccati_box.cu`` (K2
and K5 with BoxQP gains, K4 with Cholesky gains) on the card, to see what
each part of its design is worth.

    python -m aslr_to_tpu_torch.box_variants [--batch 4096 16384]

Each variant is the kernel's source (with ``boxqp.cuh`` and ``common.cuh``)
after a few text substitutions, compiled by its own ``nvcc`` (all at once)
into a library under ``build/aslr_to_tpu_torch/variants/``; a substitution
that no longer matches the source raises. K2 and K5 run in float32 at T=100
on the inputs of ``chip_smoke.py``'s kernel phase (a linearization of the
VSA arm at x0 = 0.05 randn, seed 0, zero controls, warm QPs from zero
kprev, qp_iters=2), K4 on the SEA arm (nu 2, its quasi-static controls, the
gaps of that linearization) and on the VSA arm (nu 4), timed with CUDA
events over 10 launches after a warm-up, two rounds of every variant in
turn. Each variant's outputs are compared with the unmodified kernel's: the
exact ones must equal it to the bit.

  base           the source as it is
  divide_zeros   the zero-dividend skip off: every division runs, and a zero
                 dividend takes IEEE division's slow path
  refactor       the masked factor recomputed at every QP iteration and for
                 the gains, as the plain version does
  approx_div     __fdividef and x * rsqrtf(x) for the factor's divisions and
                 square roots: a floor for what IEEE division costs (inexact)
  chol_skip0     K4's Cholesky with the zero-dividend skip of the BoxQP's
  fma            -fmad=true (inexact)
  group16/32     16 or 32 lanes a scenario
  threads64/256  blocks of 64 or 256 threads

The base kernel also runs K2 and K5 at qp_iters 0, 1, 2, 4 and 8. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import time

import torch

from .kernels import build
from .kernels import riccati as rk

FILES = ("riccati_box.cu", "boxqp.cuh", "common.cuh")
EXACT = ("base", "divide_zeros", "refactor", "chol_skip0", "group16", "group32", "threads64",
         "threads256")


def _threads(n):
    return [("riccati_box.cu", "constexpr int kSweepThreads = 128;",
             f"constexpr int kSweepThreads = {n};")]


VARIANTS = {
    "base": [],
    "divide_zeros": [("boxqp.cuh", "  if (SKIP0 && a == S(0) && b_regular) return a * b;\n", "")],
    "refactor": [("boxqp.cuh", "    if (!same) {\n      masked_factor", "    {\n      masked_factor")],
    "approx_div": [("boxqp.cuh", "  if (SKIP0 && a == S(0) && b_regular) return a * b;\n  return a / b;",
                    "  if constexpr (SKIP0 && sizeof(S) == 4) return __fdividef(a, b);\n"
                    "  return a / b;"),
                   ("boxqp.cuh", "        L[i][i] = dsqrt(s);",
                    "        if constexpr (SKIP0 && sizeof(S) == 4) L[i][i] = s * rsqrtf(s);\n"
                    "        else L[i][i] = dsqrt(s);")],
    "chol_skip0": [("riccati_box.cu", "constexpr bool kCholSkip0 = false;",
                    "constexpr bool kCholSkip0 = true;")],
    "fma": [],
    # 16 or 32 lanes a scenario (K4's (28, 7) keeps its warp)
    "group16": [("riccati_box.cu", "  constexpr int G = kSweepGroup<NDX>;",
                 "  constexpr int G = NDX > 16 ? 32 : 16;")],
    "group32": [("riccati_box.cu", "  constexpr int G = kSweepGroup<NDX>;",
                 "  constexpr int G = 32;")],
    "threads64": _threads(64),
    # K4's (28, 7) does not fit a block of 256 threads (8 scenarios' scratch)
    "threads256": _threads(256) + [
        ("riccati_box.cu",
         "  if (ndx == 28 && nu == 7) return launch_shape<S, 28, 7, true, false>(a, st);\n", "")],
}


def build_variants(names):
    """{name: loaded library}; one nvcc per variant, all at once."""
    root = build.BUILD_DIR / "variants"
    procs = {}
    for name in names:
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in FILES:
            src = (build.CSRC / f).read_text()
            for target, old, new in VARIANTS[name]:
                if target == f:
                    if old not in src:
                        raise ValueError(f"variant {name}: {old!r} is not in {f}")
                    src = src.replace(old, new)
            (d / f).write_text(src)
        flags = [x for x in build.NVCC_FLAGS if x != "-fmad=false"]
        flags.append("-fmad=true" if name == "fma" else "-fmad=false")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-shared", "-o", str(d / "lib.so"), str(d / "riccati_box.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in out.splitlines()
                if "Used" in line]
        print(f"built {name}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for base in ("aslr_riccati_box", "aslr_riccati_fddp"):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, base + suffix)
                fn.argtypes = build._SIGNATURES[base]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def box_inputs(B, T=100, dtype=torch.float32):
    """{case: (call of qp_iters, whether it takes them)}: K2 and K5 on the
    VSA arm, K4 on the SEA and VSA arms, on chip_smoke's kernel-phase
    inputs."""
    from . import two_dof_sea, two_dof_vsa_boxddp
    from .kernels import vsa_kernels as vk
    from .measure import x0_batch

    x0 = x0_batch(B, dtype, seed=0).T.contiguous()
    xs = x0.expand(T + 1, 8, B).contiguous()
    reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
    cases = {}
    for arm in ("vsa", "sea"):
        w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        if arm == "sea":
            us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        else:
            us = torch.zeros(T, spec.nu, B, dtype=dtype, device="cuda")
        lin = vk.linearize_plain(spec, xs, us, torch.full((B,), spec.w_goal_term, dtype=dtype,
                                                           device="cuda"))
        r = lin.run
        derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                  lin.term["Lx"], lin.term["Lxx"])
        fs = torch.cat([torch.zeros_like(x0)[None], lin.xnext - xs[1:]], dim=0)
        cases[f"K4 {arm.upper()}"] = (lambda it, a=derivs + (fs, reg):
                                      rk.riccati_fddp_backward(*a), False)
        if arm == "vsa":
            box = [torch.as_tensor(b, dtype=dtype, device="cuda")[:, None].expand(spec.nu, B)
                   .contiguous() for b in (spec.lb, spec.ub)]
            tail = (us, torch.zeros_like(us), box[0], box[1], reg)
            cases["K2"] = (lambda it, a=derivs + tail: rk.riccati_box_backward(*a, it), True)
            cases["K5"] = (lambda it, a=derivs + (fs,) + tail:
                           rk.riccati_boxfddp_backward(*a, it), True)
    return {k: cases[k] for k in ("K2", "K5", "K4 SEA", "K4 VSA")}


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(a, b):
    return all(torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(0), y.nan_to_num(0))
               for x, y in zip(a, b) if x is not None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 16384])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants(list(VARIANTS))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    own = build._lib
    try:
        for B in args.batch:
            for kernel, (fn, takes_qp) in box_inputs(B).items():
                build._lib = libs["base"]
                want = fn(2)
                for name, lib in libs.items():
                    build._lib = lib
                    got = fn(2)
                    torch.cuda.synchronize()
                    if name in EXACT and not same_bits(got, want):
                        raise AssertionError(f"variant {name} of {kernel} differs from base")
                for rnd in range(2):
                    times = []
                    for name, lib in libs.items():
                        build._lib = lib
                        times.append(f"{name} {cuda_ms(lambda: fn(2)):.4f}")
                    print(f"{kernel} f32 T=100 B={B} ms (round {rnd}): " + ", ".join(times),
                          flush=True)
                if takes_qp:
                    build._lib = libs["base"]
                    sweep = [f"{it}: {cuda_ms(lambda: fn(it)):.4f}" for it in (0, 1, 2, 4, 8)]
                    print(f"{kernel} base B={B} ms by qp_iters: " + ", ".join(sweep), flush=True)
    finally:
        build._lib = own


if __name__ == "__main__":
    main()
