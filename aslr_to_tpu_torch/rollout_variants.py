"""Time source variants of the rollouts (K3 and K6, ``csrc/rollout.cu``) on
the card, to see what each part of their design is worth.

    python -m aslr_to_tpu_torch.rollout_variants [--batch 4096 16384]
    python -m aslr_to_tpu_torch.rollout_variants --nl 7 [--batch 1024 4096]

Each variant is the kernel's source (with ``lanes.cuh`` and ``common.cuh``)
after a few text substitutions, compiled by its own ``nvcc`` (all at once)
into a library under ``build/aslr_to_tpu_torch/variants/``; a substitution
that no longer matches the source raises. At nl 2 (``rollout.cu``) K3 and
K6 run in float32 at T=100 on the inputs of ``chip_smoke.py``'s kernel
phase (a linearization and a plain backward at x0 = 0.05 randn, seed 0:
K3 and K6 in the VSA's box, K3 on the SEA arm with gaps); at nl 7
(``rollout_n7.cu``) K3 and K6 on the 7-DoF SEA arm with gaps, on the
inputs of its n-DoF kernel phase (the same recipe at nx = 28, the
quasi-static controls, half the lanes infeasible). Each is timed with CUDA
events over 10 launches after a warm-up, two rounds of every variant in
turn, and each variant's outputs are compared with the unmodified
kernel's: the exact ones must equal it to the bit.

  base           the source as it is: groups of 4 lanes, the running cost
                 deferred, knot inputs staged one knot a stage, K3's trials
                 on one staged copy, blocks of 128 threads
  group2/8       2 or 8 lanes a trajectory
  cost_in_chain  each knot's running cost in the dynamics chain, on every
                 lane of the group
  direct_loads   the knot inputs read from global memory where they are used
  chunk2/4       2 or 4 knots a stage
  own_copies     each of K3's trials stages its own copy of the inputs
  threads64/256  blocks of 64 or 256 threads
  k3_threads256  blocks of 256 threads for K3 only
  direct_k3_threads256  direct_loads and k3_threads256 together
  fma            -fmad=true (inexact)

At nl 7 (``--nl 7``; the wide layout of ``rollout.cuh``: 8 lanes a
trajectory, each joint's rotation computed by one lane of the group, the
deferred cost's knot in registers in f32; K6 in it in blocks of 64
threads, K3 in blocks of 128 where its general layout, 4 lanes and 16
scenarios a block, would leave SMs without a block, else in the general
one):

  n7_parent               the wide layouts in the general one's shape (4
                          lanes, 128 threads)
  n7_group4_threads64     K6 on 4 lanes in blocks of 64 threads (16
                          trajectories a block, as K3's general blocks)
  n7_threads32/128        K6's 8-lane groups in blocks of 32 or 128 threads
  n7_k3_always_general    K3 in its general layout at every batch (its
                          design before the batch rule)
  n7_k3_always_wide       K3 in its wide layout at every batch
  n7_k3_threads64/256     K3's wide groups in blocks of 64 or 256 threads
                          (4 or 16 scenarios)
  n7_k3_own_copies        each of K3's trials stages its own copy of the
                          knot (own_copies), so its threads issue twice
                          the copies a knot
  n7_own_rot              every sweep computes the joints' rotations itself
                          (K6, and K3 where wide)
  n7_kept_smem_f32        the knot whose running cost a lane defers kept in
                          a shared-memory slot of its own in f32 too (as in
                          f64), not in registers
  n7_kept_smem_own_rot    both

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

from .box_variants import cuda_ms, ptxas_lines, same_bits
from .kernels import build

FILES = ("rollout.cu", "rollout_n7.cu", "rollout.cuh", "lanes.cuh", "common.cuh")
UNITS = {2: "rollout.cu", 7: "rollout_n7.cu"}
INEXACT = ("fma",)


def _set(*pairs):
    """Substitutions that set ``constexpr`` values of rollout.cuh."""
    return [("rollout.cuh", f"constexpr {decl} = ", value) for decl, value in pairs]


def _k3_layout(wide):
    """K3's batch rule at nl 7 (rollout2_wide) made one layout at every
    batch."""
    return [("rollout.cuh", "return grid < sms", " || true" if wide else " && false")]


# the wide layout's deferred knot in shared memory in f32 too, not in f64 only
_KEPT_F32 = ("int KEPT", "WIDE ? THREADS * (NDX + NU) : 0")

VARIANTS = {
    "base": [],
    "group2": _set(("int kRollGroup", "2")),
    "group8": _set(("int kRollGroup", "8")),
    "cost_in_chain": _set(("bool kDeferCost", "false")),
    "direct_loads": _set(("bool kStaged", "false")),
    "chunk2": _set(("int kRollChunk", "2")),
    "chunk4": _set(("int kRollChunk", "4")),
    "own_copies": _set(("bool kShareStage", "false")),
    "threads64": _set(("int kRollThreads1", "64"), ("int kRollThreads2", "64")),
    "threads256": _set(("int kRollThreads1", "256"), ("int kRollThreads2", "256")),
    "k3_threads256": _set(("int kRollThreads2", "256")),
    "direct_k3_threads256": _set(("bool kStaged", "false"), ("int kRollThreads2", "256")),
    "fma": [],
    "n7_parent": _set(("int kRollGroupN7", "4"), ("int kRollThreadsN7", "128")),
    "n7_group4_threads64": _set(("int kRollGroupN7", "4")),
    "n7_threads32": _set(("int kRollThreadsN7", "32")),
    "n7_threads128": _set(("int kRollThreadsN7", "128")),
    "n7_k3_always_general": _k3_layout(False),
    "n7_k3_always_wide": _k3_layout(True),
    "n7_k3_threads64": _set(("int kRollThreads2N7", "64")),
    "n7_k3_threads256": _set(("int kRollThreads2N7", "256")),
    "n7_k3_own_copies": _set(("bool kShareStage", "false")),
    "n7_own_rot": _set(("bool kShareRotN7", "false")),
    "n7_kept_smem_f32": _set(_KEPT_F32),
    "n7_kept_smem_own_rot": _set(_KEPT_F32, ("bool kShareRotN7", "false")),
}
# the variants each chain length's unit is timed in by default
DEFAULTS = {2: [n for n in VARIANTS if not n.startswith("n7_")],
            7: ["base"] + [n for n in VARIANTS if n.startswith("n7_")]}


def variant_source(name, f):
    """The text of ``f`` in variant ``name``: each substitution sets the
    value of one ``constexpr`` of the source."""
    src = (build.CSRC / f).read_text()
    for target, decl, value in VARIANTS[name]:
        if target == f:
            pattern = re.escape(decl) + r"[^;]*;"
            if not re.search(pattern, src):
                raise ValueError(f"variant {name}: {decl!r} is not in {f}")
            src = re.sub(pattern, f"{decl}{value};", src, count=1)
    return src


def _ptxas_summary(out):
    """Registers (least, most) and whether anything spilled, over the
    kernels ptxas reports."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", out)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", out)]
    return f"{min(regs)}-{max(regs)} registers, spill bytes at most {max(spills, default=0)}"


def build_variants(names, nl=2):
    """{name: loaded library} of the unit at chain length ``nl``; one nvcc
    per variant, all at once."""
    root = build.BUILD_DIR / "variants"
    unit = UNITS[nl]
    procs = {}
    for name in names:
        d = root / f"rollout_n{nl}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in FILES:
            (d / f).write_text(variant_source(name, f))
        flags = [x for x in build.NVCC_FLAGS if x != "-fmad=false"]
        flags.append("-fmad=true" if name == "fma" else "-fmad=false")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-shared", "-o", str(d / "lib.so"), str(d / unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        print(f"built {name}: {_ptxas_summary(out)}", flush=True)
        if nl != 2:  # each instance of the unit: K3 and K6, shared and f32 / f64
            for line in ptxas_lines(out, r"rollout[12]_kernel"):
                print(f"  {name} {line}", flush=True)
        lib = ctypes.CDLL(str(root / f"rollout_n{nl}_{name}" / "lib.so"))
        for base in ("aslr_rollout2", "aslr_rollout1"):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, base + ("" if nl == 2 else f"_n{nl}") + suffix)
                fn.argtypes = build._SIGNATURES[base]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def roll_inputs(B, T=100, dtype=torch.float32):
    """{case: (wrapper, args)}: K3 and K6 in the VSA's box (K6 at K3's
    second step length), K3 on the SEA arm with gaps; the inputs of
    chip_smoke's kernel phase."""
    from . import two_dof_sea, two_dof_vsa_boxddp
    from .kernels import riccati as rk
    from .kernels import vsa_kernels as vk
    from .measure import x0_batch

    x0 = x0_batch(B, dtype, seed=0).T.contiguous()
    xs = x0.expand(T + 1, 8, B).contiguous()
    ones = torch.ones(B, dtype=dtype, device="cuda")
    reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
    cases = {}
    for arm in ("vsa", "sea"):
        w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        if arm == "sea":
            us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        else:
            us = torch.zeros(T, spec.nu, B, dtype=dtype, device="cuda")
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
        lin = vk.linearize_plain(spec, xs, us, wterm)
        r = lin.run
        derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                  lin.term["Lx"], lin.term["Lxx"])
        if arm == "vsa":
            lb, ub = (torch.as_tensor(b, dtype=dtype, device="cuda")[:, None].expand(spec.nu, B)
                      .contiguous() for b in (spec.lb, spec.ub))
            bw = rk.riccati_box_plain(*derivs, us, torch.zeros_like(us), lb, ub, reg, 2)
            k3 = (spec, xs, us, bw.k, bw.K, x0, ones, 0.5 * ones, wterm, lb, ub)
            cases["K3 box"] = (vk.rollout2, k3)
            cases["K6 box"] = (vk.rollout1, k3[:6] + k3[7:])
        else:
            fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
            bw = rk.riccati_fddp_plain(*derivs, fs, reg)
            k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
            infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
            cases["K3 SEA gaps"] = (vk.rollout2, (spec, xs, us, k, K, x0, ones, 0.5 * ones,
                                                  wterm, None, None, fs, infeas))
    return cases


def roll_inputs_n7(B, T=100, dtype=torch.float32):
    """{case: (wrapper, args)}: K3 and K6 (at K3's second step length) on
    the 7-DoF SEA arm with gaps, unboxed; the inputs of chip_smoke's n-DoF
    kernel phase."""
    from . import seven_dof_sea
    from .kernels import riccati as rk
    from .kernels import vsa_kernels as vk
    from .measure import x0_batch

    w = seven_dof_sea(T=T, dtype=dtype)
    spec = vk.extract_vsa_spec(w.problem, w.bounds)
    x0 = x0_batch(B, dtype, seed=0, nx=spec.ndx).T.contiguous()
    xs = x0.expand(T + 1, spec.ndx, B).contiguous()
    us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
    lin = vk.linearize_plain(spec, xs, us, wterm)
    r = lin.run
    fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
    reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
    bw = rk.riccati_fddp_plain(r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                               lin.term["Lx"], lin.term["Lxx"], fs, reg)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(B, dtype=dtype, device="cuda")
    infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
    k3 = (spec, xs, us, k, K, x0, ones, 0.5 * ones, wterm, None, None, fs, infeas)
    return {"K6 nl 7": (vk.rollout1, k3[:6] + k3[7:]), "K3 nl 7": (vk.rollout2, k3)}


def _flat(out):
    """The tensors of K6's Trial or of K3's two."""
    return list(out) if hasattr(out, "cost") else [t for trial in out for t in trial]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nl", type=int, choices=sorted(UNITS), default=2,
                    help="the chain length whose unit and cases are timed")
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batches (default 4096 16384 at nl 2, 1024 4096 at nl 7)")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS), help="variants to build")
    args = ap.parse_args(argv)
    batches = args.batch or ([4096, 16384] if args.nl == 2 else [1024, 4096])
    inputs = roll_inputs if args.nl == 2 else roll_inputs_n7
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    names = ["base"] + [n for n in (args.only or DEFAULTS[args.nl]) if n != "base"]
    t0 = time.perf_counter()
    libs = build_variants(names, args.nl)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    own = build._lib
    try:
        for B in batches:
            for case, (fn, kargs) in inputs(B).items():
                build._lib = libs["base"]
                want = _flat(fn(*kargs))
                for name, lib in libs.items():
                    build._lib = lib
                    got = _flat(fn(*kargs))
                    torch.cuda.synchronize()
                    if name not in INEXACT and not same_bits(got, want):
                        raise AssertionError(f"variant {name} of {case} differs from base")
                for rnd in range(2):
                    times = []
                    for name, lib in libs.items():
                        build._lib = lib
                        times.append(f"{name} {cuda_ms(lambda: fn(*kargs)):.4f}")
                    print(f"{case} f32 T=100 B={B} ms (round {rnd}): " + ", ".join(times),
                          flush=True)
    finally:
        build._lib = own


if __name__ == "__main__":
    main()
