"""Time source variants of the rollouts (K3 and K6, ``csrc/rollout.cu``) on
the card, to see what each part of their design is worth.

    python -m aslr_to_tpu_torch.rollout_variants [--batch 4096 16384]
    python -m aslr_to_tpu_torch.rollout_variants --nl 7 [--batch 1024 4096]
        [--only NAME ...] [--iterate 3] [--sass]

Each variant is the kernel's source (with ``lanes.cuh`` and ``common.cuh``)
after a few text substitutions, compiled by its own ``nvcc`` (all at once)
into a library under ``build/aslr_to_tpu_torch/variants/``; a substitution
that no longer matches the source raises. At nl 2 (``rollout.cu``) K3 and
K6 run in float32 at T=100 on the inputs of ``chip_smoke.py``'s kernel
phase (a linearization and a plain backward at x0 = 0.05 randn, seed 0:
K3 and K6 in the VSA's box, K3 on the SEA arm with gaps); at nl 7 K3 and
K6 on the 7-DoF SEA arm in its three variants (below). Each is timed with
CUDA events over 10 launches after a warm-up, two rounds of every variant
in turn, and each variant's outputs are compared with the unmodified
kernel's: an exact one that differs in a bit raises.

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
trajectory, each joint's rotation computed by one lane of the group and
kept in the group's ring, the knot's serial tail split over the group, the
deferred cost's knot in registers in f32; K6 in it in blocks of 64
threads, K3 in blocks of 128 where its general layout, 4 lanes and 16
scenarios a block, would leave SMs without a block, else in the general
one), the units ``rollout_n7.cu`` (FDDP's gap instance),
``rollout_n7_sea.cu`` (DDP's) and ``rollout_n7_box.cu`` (BoxFDDP's), on
the inputs of chip_smoke's n-DoF kernel phases (``roll_inputs_n7``) and,
with ``--iterate PASSES``, on each variant's 7-DoF lane solve's first
rollout after that pass (``iterate_inputs_n7``). The forms that the wide
knot replaced are not in the source; each variant below that names one
puts it back as a patch:

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
  n7_parent_knot          the knot before the tail was split and the
                          rotations kept: every lane runs the whole tail,
                          the rotations exchanged by 63 shuffles, each
                          deferred cost computes its knot's rotations again
  n7_whole_tail           the serial tail whole on every lane (the M / nle
                          exchange, the spring torque, the factor, the
                          solves and Binv), the rest as the kernel
  n7_split_solve          the triangular solves split over the rows too, each
                          y and x handed out by a shuffle as it is made
  n7_no_ring              no ring of rotations: the sweeps take them by 63
                          shuffles, the deferred costs compute them again
  n7_shfl_sweep           the ring for the deferred costs only; the sweeps
                          take the rotations by shuffles
  n7_array_sweep          the sweep's forward pass in rnea's arrays (local
                          memory where it stays a loop), not carried
  n7_sincos               the sine and cosine of the rotation a lane makes
                          for its group from one range reduction (sincosf /
                          sincos)
  n7_phase_clock          the kernel with clock64() stamps around a knot's
                          phases, summed by trajectory class (phase_clock)
  n7_phase_clock_parent   the same stamps in n7_parent_knot

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from .box_variants import cuda_ms, ptxas_lines, same_bits, sass_counts
from .kernels import build

HEADERS = ("rollout.cuh", "lanes.cuh", "common.cuh")
UNITS = {2: ("rollout.cu",), 7: ("rollout_n7.cu", "rollout_n7_sea.cu", "rollout_n7_box.cu")}
INEXACT = ("fma",)


def _set(*pairs):
    """Substitutions that set ``constexpr`` values of rollout.cuh."""
    return [("rollout.cuh", re.escape(f"constexpr {decl} = ") + r"[^;]*;",
             f"constexpr {decl} = {value};") for decl, value in pairs]


def _lit(f, old, new):
    """A substitution of the literal text ``old`` of ``f``."""
    return (f, re.escape(old), new.replace("\\", "\\\\"))


def _k3_layout(wide):
    """K3's batch rule at nl 7 (rollout2_wide) made one layout at every
    batch."""
    return [_lit("rollout.cuh", "return grid < sms", "return grid < sms" +
                 (" || true" if wide else " && false"))]


# the wide layout's deferred knot in shared memory in f32 too, not in f64 only
_KEPT_F32 = ("int KEPT", "WIDE ? THREADS * (NDX + NU) : 0")

# the phase clock: each lane sums the clock64() cycles of a knot's phases
# (rollout.cuh's ROLL_PHASE hooks: 0 the stage wait and block barrier, 1 the
# feedback rows, 2 the rotations and their exchange, 3 the sweep, 4 the
# M / nle exchange, 5 the serial tail and the Euler step, 6 the deferred
# cost and its fold, 7 the ragged tail's costs and the terminal cost) and
# adds them, at the end, to a buffer of the host's (aslr_roll_clock_buf) by
# the trajectory's class: 0 its final state finite with every link angle
# within sinf's fast range (105,615 rad), 1 finite beyond it, 2 not finite;
# slot 8 of a class counts its trajectories (one lane a group)
PHASES = ("stage wait and barrier", "feedback rows", "rotations and exchange", "sweep",
          "M/nle exchange", "serial tail and Euler", "deferred cost and fold",
          "ragged tail and terminal")
CLASSES = ("finite", "beyond the fast range", "not finite")
_CLOCK = r"""
extern "C" unsigned long long* aslr_roll_clock_buf;
#define ROLL_PHASE_CLOCK 1
#define ROLL_PHASE_BEGIN()              \
  long long clk_t0_ = clock64();        \
  unsigned long long clk_acc_[8] = {};
#define ROLL_PHASE(p)                                            \
  {                                                              \
    const long long clk_n_ = clock64();                          \
    clk_acc_[p] += (unsigned long long)(clk_n_ - clk_t0_);       \
    clk_t0_ = clk_n_;                                            \
  }
#define ROLL_PHASE_END()                                                       \
  if (live && a.clk) {                                                         \
    int cls_ = 0;                                                              \
    for (int i_ = 0; i_ < NDX; ++i_) cls_ = isfinite(x[i_]) ? cls_ : 2;        \
    for (int i_ = 0; i_ < NL; ++i_)                                            \
      cls_ = cls_ == 0 && fabs((double)x[i_]) > 105615.0 ? 1 : cls_;           \
    for (int p_ = 0; p_ < 8; ++p_) atomicAdd(a.clk + cls_ * 9 + p_, clk_acc_[p_]); \
    if (lane == 0) atomicAdd(a.clk + cls_ * 9 + 8, 1ull);                      \
  }
"""
_PHASE_CLOCK = [
    _lit("rollout.cuh", '#include "lanes.cuh"\n', '#include "lanes.cuh"\n' + _CLOCK),
    _lit("rollout.cuh", "S *xs_a, *us_a, *cost_a, *xs_b, *us_b, *cost_b;",
         "S *xs_a, *us_a, *cost_a, *xs_b, *us_b, *cost_b;\n  unsigned long long* clk = nullptr;"),
    _lit("rollout.cuh", "  a.vec = a.B % (16 / (int)sizeof(S)) == 0;",
         "  a.clk = aslr_roll_clock_buf;\n  a.vec = a.B % (16 / (int)sizeof(S)) == 0;"),
    ("rollout_n7.cu", r"\Z", '\nextern "C" {\nunsigned long long* aslr_roll_clock_buf = nullptr;\n}\n'),
]

# The forms the wide knot at nl 7 replaced, as patches of rollout.cuh (and
# of lanes.cuh and common.cuh for the one range reduction).
# The ring slot that every sweep reads, and the shuffles it replaced
_RING_SWEEP = """        // every sweep reads the rotations from the knot's ring slot
        grp.sync();
        ROLL_PHASE(2);
        auto Eg = [now](int i) {
          Mat3<S> E;
          for (int r = 0; r < 3; ++r)
            for (int c3 = 0; c3 < 3; ++c3) E.m[r][c3] = now[i * 9 + r * 3 + c3];
          return E;
        };
        mass_nle_sweep<S, NL, true, decltype(Eg), true>(P, x, x + 2 * NL, cs, sw[0], Eg);
"""
_SHFL_SWEEP = """        Mat3<S> Es[NL];
        for (int i = 0; i < NL; ++i)
          for (int r = 0; r < 3; ++r)
            for (int c3 = 0; c3 < 3; ++c3) Es[i].m[r][c3] = grp.from(i, mine.m[r][c3]);
        ROLL_PHASE(2);
        mass_nle_sweep<S, NL, true>(P, x, x + 2 * NL, cs, sw[0], Es);
"""
_RING_WRITE = """        S* const now = rot_ring + (t % G) * NL * 9;
        if (lane < NL)
          for (int r = 0; r < 3; ++r)
            for (int c3 = 0; c3 < 3; ++c3) now[lane * 9 + r * 3 + c3] = mine.m[r][c3];
"""
_SHFL_SWEEPS = [_lit("rollout.cuh", _RING_SWEEP, _SHFL_SWEEP)]
_NO_RING = [
    _lit("rollout.cuh", "ROT_RING = WIDE && kShareRotN7 && NL + 1 <= G;", "ROT_RING = false;"),
    _lit("rollout.cuh", '  static_assert(!SHARE_ROT || L::ROT_RING, "shared rotations go through '
         'the ring");\n', ""),
    _lit("rollout.cuh", _RING_WRITE + "        const int cs = lane < NL ? lane : NL;\n" + _RING_SWEEP,
         "        const int cs = lane < NL ? lane : NL;\n" + _SHFL_SWEEP),
]
_WHOLE_TAIL = [_lit("rollout.cuh", "SPLIT_TAIL = SHARE_ROT && SEA;", "SPLIT_TAIL = false;")]
_SPLIT_SOLVE = [_lit("rollout.cuh", """  S Lf[NL][NL];
  for (int p = 0; p < NL; ++p) {
    const S root = dsqrt(s[p]);
    const S dp = grp.from(p, root);
    const S lrp = r == p ? root : s[p] / dp;
    Lf[p][p] = dp;
    for (int j = p + 1; j < NL; ++j) {
      const S ljp = grp.from(j, lrp);
      Lf[j][p] = ljp;
      s[j] = p < r && j <= r ? s[j] - lrp * ljp : s[j];
    }
  }
  S rhs[NL];
  for (int i = 0; i < NL; ++i) rhs[i] = -nle[i] - tau[i];
  choln_solve<S, NL>(Lf, rhs, acc);
""", """  // lrow[p] = L[r][p] (p <= r), lcol[k] = L[k][r] (k > r)
  S lrow[NL], lcol[NL];
  for (int p = 0; p < NL; ++p) {
    const S root = dsqrt(s[p]);
    const S dp = grp.from(p, root);
    const S lrp = r == p ? root : s[p] / dp;
    lrow[p] = lrp;
    for (int j = p + 1; j < NL; ++j) {
      const S ljp = grp.from(j, lrp);
      lcol[j] = r == p ? ljp : lcol[j];
      s[j] = p < r && j <= r ? s[j] - lrp * ljp : s[j];
    }
  }
  // L y = -nle - tau_c: lane r's sum in k order, y_p handed out as made
  S nle_r = nle[0];
  for (int i = 1; i < NL; ++i) nle_r = r == i ? nle[i] : nle_r;
  S sy = -nle_r - tau_r;
  S diag = lrow[0], y_r = S(0);
  for (int p = 0; p < NL; ++p) {
    const S yp = grp.from(p, sy / lrow[p]);
    if (p < r) sy = sy - lrow[p] * yp;
    diag = r == p ? lrow[p] : diag;
    y_r = r == p ? yp : y_r;
  }
  // L^T x = y, from the last row: lane i's sum over k = i + 1 .. in order
  for (int i = NL - 1; i >= 0; --i) {
    S sx = y_r;
    for (int k = i + 1; k < NL; ++k) sx = sx - lcol[k] * acc[k];
    acc[i] = grp.from(i, sx / diag);
  }
""")]
_SINCOS = [
    _lit("common.cuh", "__device__ inline double dcos(double x) { return cos(x); }\n",
         "__device__ inline double dcos(double x) { return cos(x); }\n"
         "__device__ inline void dsincos(float x, float* s, float* c) { sincosf(x, s, c); }\n"
         "__device__ inline void dsincos(double x, double* s, double* c) { sincos(x, s, c); }\n"),
    _lit("lanes.cuh", """template <class V> __device__ inline Mat3<V> rot_axis_angle(const double* axis, V q) {
  const double ax = axis[0], ay = axis[1], az = axis[2];
  V c = dcos(q), s = dsin(q);
""", """template <class V, bool SINCOS = false>
__device__ inline Mat3<V> rot_axis_angle(const double* axis, V q) {
  const double ax = axis[0], ay = axis[1], az = axis[2];
  V c, s;
  if constexpr (SINCOS) {
    dsincos(q, &s, &c);
  } else {
    c = dcos(q);
    s = dsin(q);
  }
"""),
    _lit("lanes.cuh", "m_mul(m_const<V>(j.rot), rot_axis_angle(j.axis, q))",
         "m_mul(m_const<V>(j.rot), rot_axis_angle<V, true>(j.axis, q))"),
]

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
    "n7_sincos": _SINCOS,
    "n7_whole_tail": _WHOLE_TAIL,
    "n7_split_solve": _SPLIT_SOLVE,
    "n7_array_sweep": [_lit("rollout.cuh", "decltype(Eg), true>(P, x,", "decltype(Eg), false>(P, x,")],
    "n7_no_ring": _NO_RING,
    "n7_shfl_sweep": _SHFL_SWEEPS,
    "n7_parent_knot": _WHOLE_TAIL + _NO_RING,
    "n7_phase_clock": _PHASE_CLOCK,
    "n7_phase_clock_parent": _PHASE_CLOCK + _WHOLE_TAIL + _NO_RING,
}
# the variants each chain length's unit is timed in by default
DEFAULTS = {2: [n for n in VARIANTS if not n.startswith("n7_")],
            7: ["base"] + [n for n in VARIANTS if n.startswith("n7_")]}


def variant_source(name, f):
    """The text of ``f`` in variant ``name``: each substitution replaces
    the first match of its pattern."""
    src = (build.CSRC / f).read_text()
    for target, pattern, value in VARIANTS[name]:
        if target == f:
            if not re.search(pattern, src):
                raise ValueError(f"variant {name}: {pattern!r} is not in {f}")
            src = re.sub(pattern, value, src, count=1)
    return src


def _ptxas_summary(out):
    """Registers (least, most) and whether anything spilled, over the
    kernels ptxas reports."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", out)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", out)]
    return f"{min(regs)}-{max(regs)} registers, spill bytes at most {max(spills, default=0)}"


def _nvcc_flags(name):
    """The build's flags; -fno-gnu-unique: the units' template statics
    (rollout.cuh::NdofUnit, filled as a library loads) stay each variant's
    own, where GCC's unique binding would make one of them every loaded
    library's, and every variant would launch that library's DDP and
    BoxFDDP instances."""
    flags = [x for x in build.NVCC_FLAGS if x != "-fmad=false"]
    return flags + ["-fmad=true" if name == "fma" else "-fmad=false",
                    "-Xcompiler", "-fno-gnu-unique"]


def build_variants(names, nl=2, sass=False, sass_dump=None):
    """{name: loaded library} of the units at chain length ``nl`` (at nl 7
    the gap instance's and DDP's and BoxFDDP's variants); one nvcc per
    variant and unit, all at once, then one link a variant. ``sass``:
    each variant's SASS opcode counts of its K6 and K3 f32 instances;
    ``sass_dump``: a directory for the base variant's K6 f32 DDP instance's
    full SASS."""
    root = build.BUILD_DIR / "variants"
    units = UNITS[nl]
    procs = {}
    for name in names:
        d = root / f"rollout_n{nl}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in HEADERS + units:
            (d / f).write_text(variant_source(name, f))
        for unit in units:
            procs[name, unit] = subprocess.Popen(
                [build._nvcc(), *_nvcc_flags(name), "-c", "-o", str(d / (unit + ".o")),
                 str(d / unit)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    outs = {}
    for (name, unit), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {unit}\n{out}")
        outs[name] = outs.get(name, "") + out
    libs = {}
    for name in names:
        d = root / f"rollout_n{nl}_{name}"
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-o", str(d / "lib.so"), *(str(d / (u + ".o")) for u in units)],
                       check=True, capture_output=True, text=True)
        print(f"built {name}: {_ptxas_summary(outs[name])}", flush=True)
        if nl != 2:  # each instance of the units: K3 and K6, f32 and f64
            for line in ptxas_lines(outs[name], r"rollout[12]_kernel"):
                print(f"  {name} {line}", flush=True)
        if sass:
            print_sass(name, d / "lib.so", nl, sass_dump)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for base in ("aslr_rollout2", "aslr_rollout1"):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, base + ("" if nl == 2 else f"_n{nl}") + suffix)
                fn.argtypes = build._SIGNATURES[base]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


SASS_KEYS = ("SHFL", "MUFU", "CALL", "RET", "BRA", "BSSY", "LDS", "STS", "LDL", "STL", "LDG",
             "STG", "FMUL", "FADD", "FSEL", "FSETP", "I2F", "F2I", "IMAD", "BAR")


def print_sass(name, lib_path, nl, dump=None):
    """Each K6 / K3 f32 instance's static instruction count and the opcodes
    of its chain; with ``dump``, the base variant's K6 f32 DDP instance
    ("sea") also in full into that directory, for reading where its local
    memory sits."""
    pattern = rf"rollout[12]_kernelIfLi{nl}E"
    for kernel, (total, ops) in sass_counts(lib_path, pattern).items():
        short = re.sub(r"^_ZN4aslr\d+|EEEvN.*$", "", kernel)
        print(f"  {name} sass {short}: {total} instructions; "
              + ", ".join(f"{k} {ops[k]}" for k in SASS_KEYS if k in ops), flush=True)
    if name == "base" and dump:
        cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
        out = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                             text=True, check=True).stdout
        keep, lines = False, []
        for line in out.splitlines():
            if "Function :" in line:
                keep = bool(re.search(rf"rollout1_kernelIfLi{nl}ELb1ELb0ELb0E", line))
            if keep:
                lines.append(line)
        dest = Path(dump) / f"rollout1_n{nl}_sea_f32.sass"
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text("\n".join(lines))
        print(f"  base sass of K6 f32 sea in {dest} ({len(lines)} lines)", flush=True)


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
    the 7-DoF SEA arm in each variant, on the inputs of chip_smoke's n-DoF
    kernel phases: "gaps" (FDDP's, K4's gains, half the lanes infeasible),
    "sea" (DDP's, K4's gains) and "box gaps" (BoxFDDP's, K5's gains in the
    sevendof_box path's box, which binds), from the quasi-static controls
    (chip_smoke.kernel_cases, ndof_box_cases)."""
    import chip_smoke as cs

    cases = {}
    for label, case in list(cs.kernel_cases(dtype, B, ("sea7",), T=T).items()) + list(
            cs.ndof_box_cases(dtype, B, ("sea7",)).items()):
        m = re.fullmatch(r"(rollout[12])\[sea7( gaps| box gaps|)\]", label)
        if m:
            name = {"rollout1": "K6", "rollout2": "K3"}[m.group(1)]
            cases[f"{name} {m.group(2).strip() or 'sea'}"] = (case[0].func, case[0].args)
    return cases


ITERATE_PATHS = {"gaps": "sevendof", "sea": "sevendof_ddp", "box gaps": "sevendof_box"}


def iterate_inputs_n7(B, passes):
    """{case: (wrapper, args)}: K3 and K6 on the first two-trial rollout's
    arguments after loop pass ``passes`` of each variant's 7-DoF lane solve
    (ITERATE_PATHS; measure.py's seeds), run through the tree's kernels."""
    from .kernels import vsa_kernels as vk
    from .rollout_box_excess import capture

    cases = {}
    for variant, path in ITERATE_PATHS.items():
        args = capture(B, passes, path)
        cases[f"K3 {variant} iterate"] = (vk.rollout2, args)
        cases[f"K6 {variant} iterate"] = (vk.rollout1, args[:6] + args[7:])
    return cases


def phase_clock(lib, fn, args, T):
    """One launch of ``fn`` through the phase-clock variant ``lib``: per
    class of trajectory, the count and each phase's cycles a knot (summed
    over a group's lanes, over its lanes and knots)."""
    buf = torch.zeros(3 * 9, dtype=torch.int64, device="cuda")
    ptr = ctypes.c_void_p.in_dll(lib, "aslr_roll_clock_buf")
    ptr.value = buf.data_ptr()
    try:
        fn(*args)
        torch.cuda.synchronize()
    finally:
        ptr.value = None
    acc = buf.view(3, 9).double().cpu()
    print(f"  phase clock buffer: {buf.view(3, 9).tolist()}", flush=True)
    out = {}
    for c, cls in enumerate(CLASSES):
        n = int(acc[c, 8])
        if n:
            lanes = 8 * n * T   # every lane of a group stamps the clock
            out[cls] = dict(count=n, cycles={p: float(acc[c, i]) / lanes
                                             for i, p in enumerate(PHASES)})
    return out


def _print_phases(case, B, phases):
    for cls, rec in phases.items():
        total = sum(rec["cycles"].values())
        print(f"  phases {case} B={B} {cls} ({rec['count']} trajectories): {total:.0f} cycles a "
              "knot; " + ", ".join(f"{p} {v:.0f}" for p, v in rec["cycles"].items()),
              flush=True)


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
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS opcode counts of its f32 instances")
    ap.add_argument("--sass-dump", metavar="DIR",
                    help="with --sass, write the base variant's K6 f32 DDP instance's SASS "
                         "into DIR")
    ap.add_argument("--iterate", type=int, metavar="PASSES", default=0,
                    help="nl 7: also time on the first rollout after loop pass PASSES of each "
                         "variant's 7-DoF lane solve (builds the tree's kernels)")
    args = ap.parse_args(argv)
    batches = args.batch or ([4096, 16384] if args.nl == 2 else [1024, 4096])
    inputs = roll_inputs if args.nl == 2 else roll_inputs_n7
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on the card")
    sys.path.insert(0, ".")     # chip_smoke's cases, from the repository's root
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    # the tree's kernels (for the solves of --iterate) build beside the
    # variants
    main_build = None
    if args.iterate:
        main_build = threading.Thread(target=build.build)
        main_build.start()
    names = ["base"] + [n for n in (args.only or DEFAULTS[args.nl]) if n != "base"]
    t0 = time.perf_counter()
    libs = build_variants(names, args.nl, sass=args.sass, sass_dump=args.sass_dump)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    if main_build is not None:
        main_build.join()
    own = build._lib
    clocks = {n: libs.pop(n) for n in list(libs) if n.startswith("n7_phase_clock")}
    try:
        runs = [(B, inputs(B)) for B in batches]
        if args.iterate and args.nl == 7:
            build._lib = own
            runs.append((batches[0], iterate_inputs_n7(batches[0], args.iterate)))
        for B, cases in runs:
            for case, (fn, kargs) in cases.items():
                build._lib = libs["base"]
                want = _flat(fn(*kargs))
                for name, lib in list(libs.items()) + list(clocks.items()):
                    build._lib = lib
                    got = _flat(fn(*kargs))
                    torch.cuda.synchronize()
                    if name not in INEXACT and not same_bits(got, want):
                        raise AssertionError(f"variant {name} of {case} B={B} differs from base")
                for rnd in range(2):
                    times = []
                    for name, lib in libs.items():
                        build._lib = lib
                        times.append(f"{name} {cuda_ms(lambda: fn(*kargs)):.4f}")
                    print(f"{case} f32 T=100 B={B} ms (round {rnd}): " + ", ".join(times),
                          flush=True)
                for name, clock in clocks.items():
                    build._lib = clock
                    print(f"{case} B={B}: {name} {cuda_ms(lambda: fn(*kargs)):.4f} ms",
                          flush=True)
                    _print_phases(f"{case} {name}", B,
                                  phase_clock(clock, fn, kargs, kargs[2].shape[0]))
    finally:
        build._lib = own


if __name__ == "__main__":
    main()
