"""Time source variants of the linearization (K1, ``csrc/linearize.cuh``)
on the card, to see what each part of its design is worth.

    python -m aslr_to_tpu_torch.linearize_variants [--batch 4096 16384]
    python -m aslr_to_tpu_torch.linearize_variants --arms sea7 --only group1 group4

Each variant is the kernel's source (``linearize.cuh`` with ``lanes.cuh``
and ``common.cuh``; built through ``linearize.cu``, and ``linearize_n7.cu``
where the 7-DoF arm is asked for) after a few text substitutions, compiled
by its own ``nvcc`` (all at once) into a library under
``build/aslr_to_tpu_torch/variants/``; a substitution that no longer matches
the source raises. K1 runs in float32 at T=100 on the inputs of
``chip_smoke.py``'s kernel phase (x0 = 0.05 randn, seed 0, at every knot;
zero controls on the VSA arm, the quasi-static ones on the SEA arms: the
2-DoF ``sea`` and the 7-DoF ``sea7``), timed with CUDA events over 10
launches after a warm-up, two rounds of every variant in turn. Each
variant's outputs are compared with the unmodified kernel's: the exact ones
must equal it to the bit. Each variant's registers, stack frame and spills,
from ptxas, are printed per
instantiation.

  base         the source as it is: a (knot, scenario) on 2 lanes, the
               outputs stored straight to global memory
  group1/4/8   1, 4 or 8 lanes a (knot, scenario) (1: one thread runs every
               seed and sweep in series, as the earlier design did)
  staged       the outputs through the block's shared memory, written out
               along the batch axis at the end (also at 4 lanes)
  unroll       every loop of the sources fully unrolled (also at 4 lanes):
               the dual RNEA's arrays then live in registers, not in the
               stack frame
  no_stores    the outputs summed into one value a lane instead of stored
               (also at 4 lanes; inexact: what the stores cost)
  fma          -fmad=true (inexact)

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import time

import torch

from .box_variants import cuda_ms, same_bits
from .kernels import build

FILES = ("linearize.cu", "linearize_n7.cu", "linearize.cuh", "lanes.cuh", "common.cuh")
INEXACT = ("fma", "no_stores", "group4_no_stores")


def _unroll(f, src):
    """``#pragma unroll`` before every loop that starts a statement."""
    out, prev = [], ""
    for line in src.splitlines():
        if re.match(r"\s*for \(", line) and (prev.rstrip().endswith((";", "{", "}"))
                                             or prev.strip().startswith("//")):
            out.append("#pragma unroll")
        out.append(line)
        prev = line if line.strip() else prev
    return "\n".join(out) + "\n"


def _no_stores(f, src):
    """Each output added to a per-lane sum, which is stored only if it equals
    a value it never takes."""
    if f != "linearize.cuh":
        return src
    for old, new in (("  auto store = [&](bool cond, int e, S* dst, S v) {",
                      "  S sink = S(0);\n  auto store = [&](bool cond, int e, S* dst, S v) {"),
                     ("      if (cond) *dst = v;", "      if (cond) sink = sink + v;"),
                     ("  fin = grp.all(fin);",
                      "  if (sink == S(12345.678)) a.Fx[0] = sink;\n  fin = grp.all(fin);")):
        if old not in src:
            raise ValueError(f"no_stores: {old!r} is not in {f}")
        src = src.replace(old, new, 1)
    return src


# each variant a list of steps: (declaration, value) sets one constexpr of
# linearize.cuh; a function (file, text) -> text rewrites any file
VARIANTS = {
    "base": [],
    "group1": [("int kLinGroup", "1")],
    "group4": [("int kLinGroup", "4")],
    "group8": [("int kLinGroup", "8")],
    "staged": [("bool kStageOut", "true")],
    "group4_staged": [("int kLinGroup", "4"), ("bool kStageOut", "true")],
    "unroll": [_unroll],
    "group4_unroll": [("int kLinGroup", "4"), _unroll],
    "no_stores": [_no_stores],
    "group4_no_stores": [("int kLinGroup", "4"), _no_stores],
    "fma": [],
}


def variant_source(name, f):
    """The text of ``f`` in variant ``name``."""
    src = (build.CSRC / f).read_text()
    for step in VARIANTS[name]:
        if callable(step):
            src = step(f, src)
            continue
        if f != "linearize.cuh":
            continue
        decl, value = step
        pattern = re.escape(f"constexpr {decl} = ") + r"[^;]*;"
        if not re.search(pattern, src):
            raise ValueError(f"variant {name}: {decl!r} is not in {f}")
        src = re.sub(pattern, f"constexpr {decl} = {value};", src, count=1)
    return src


def ptxas_lines(out):
    """One line per kernel instantiation: registers, stack frame, spills."""
    entry = re.compile(r"Compiling entry function '\w*?(\w+_kernel)I([fd])Li(\d+)ELb([01])E")
    lines, name, frame = [], None, ""
    for line in out.splitlines():
        m = entry.search(line)
        if m:
            kernel, s, nl, sea = m.groups()
            name = (f"{kernel} {'f32' if s == 'f' else 'f64'} nl {nl} "
                    f"{'SEA' if sea == '1' else 'VSA'}")
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split('Used')[1].split(',')[0].strip()}; {frame}")
            name = None
    return lines


def build_variants(names, n7=False):
    """{name: loaded library}; one nvcc per variant, all at once; ``n7``
    adds the 7-DoF instance (``linearize_n7.cu``)."""
    root = build.BUILD_DIR / "variants"
    procs = {}
    for name in names:
        d = root / f"linearize_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in FILES:
            (d / f).write_text(variant_source(name, f))
        flags = [x for x in build.NVCC_FLAGS if x != "-fmad=false"]
        flags.append("-fmad=true" if name == "fma" else "-fmad=false")
        units = [str(d / "linearize.cu")] + ([str(d / "linearize_n7.cu")] if n7 else [])
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-shared", "-o", str(d / "lib.so"), *units],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        for line in ptxas_lines(out):
            print(f"built {name}: {line}", flush=True)
        lib = ctypes.CDLL(str(root / f"linearize_{name}" / "lib.so"))
        for entry in ["aslr_linearize"] + (["aslr_linearize_n7"] if n7 else []):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, entry + suffix)
                fn.argtypes = build._SIGNATURES["aslr_linearize"]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def lin_inputs(B, arms, T=100, dtype=torch.float32):
    """{case: args of vsa_kernels.linearize}: the arms (vsa, sea, sea7) on
    the inputs of chip_smoke's kernel phase."""
    from . import seven_dof_sea, two_dof_sea, two_dof_vsa_boxddp
    from .kernels import vsa_kernels as vk
    from .measure import x0_batch

    presets = dict(vsa=two_dof_vsa_boxddp, sea=two_dof_sea, sea7=seven_dof_sea)
    cases = {}
    for arm in arms:
        w = presets[arm](T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        x0 = x0_batch(B, dtype, seed=0, nx=spec.ndx).T.contiguous()
        xs = x0.expand(T + 1, spec.ndx, B).contiguous()
        if arm != "vsa":
            us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        else:
            us = torch.zeros(T, spec.nu, B, dtype=dtype, device="cuda")
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
        cases[f"K1 {arm.upper()}"] = (spec, xs, us, wterm)
    return cases


def _flat(lin):
    return [lin.cost, lin.xnext, lin.ok, *lin.run.values(), *lin.term.values()]


def main(argv=None):
    from .kernels import vsa_kernels as vk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 16384])
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS), help="variants to build")
    ap.add_argument("--arms", nargs="+", choices=["vsa", "sea", "sea7"], default=["vsa", "sea"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    names = ["base"] + [n for n in (args.only or VARIANTS) if n != "base"]
    t0 = time.perf_counter()
    libs = build_variants(names, n7="sea7" in args.arms)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    own = build._lib
    try:
        for B in args.batch:
            for case, kargs in lin_inputs(B, args.arms).items():
                build._lib = libs["base"]
                want = _flat(vk.linearize(*kargs))
                for name, lib in libs.items():
                    build._lib = lib
                    got = _flat(vk.linearize(*kargs))
                    torch.cuda.synchronize()
                    if name not in INEXACT and not same_bits(got, want):
                        raise AssertionError(f"variant {name} of {case} differs from base")
                for rnd in range(2):
                    times = []
                    for name, lib in libs.items():
                        build._lib = lib
                        times.append(f"{name} {cuda_ms(lambda: vk.linearize(*kargs)):.4f}")
                    print(f"{case} f32 T=100 B={B} ms (round {rnd}): " + ", ".join(times),
                          flush=True)
    finally:
        build._lib = own


if __name__ == "__main__":
    main()
