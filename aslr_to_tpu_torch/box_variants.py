"""Time source variants of the group kernel of ``csrc/riccati_box.cu`` (K2
and K5 with BoxQP gains, K4 with Cholesky gains) on the card, to see what
each part of its design is worth.

    python -m aslr_to_tpu_torch.box_variants [--batch 4096 16384]
    python -m aslr_to_tpu_torch.box_variants --shape 28x7 [--batch 1024 4096] [--sass]
    python -m aslr_to_tpu_torch.box_variants --shape 28x7 --only k5_warp_qp k5_trials1

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

The base kernel also runs K2 and K5 at qp_iters 0, 1, 2, 4 and 8. With
``--shape 28x7``, K4 and K5 at the 7-DoF SEA arm's (28, 7) instead, on the
inputs of chip_smoke's n-DoF kernel phase (its linearization at x0 = 0.05
randn, seed 0, nx = 28, the quasi-static controls and their gaps; K5 warm
from zero kprev in the sevendof_box path's box), against the variants of
their wide layout:

  wide_threads64 blocks of 64 threads (2 scenarios; 256 threads' eight
                 scenarios do not fit a block in f64)
  wide_park_f32  row r of Qxx parked in the exchange across the factor in
                 f32 too (as in f64), not kept in registers (K4; K5 parks)
  k5_no_park     K5 keeps row r of Qxx in registers in f32
  k5_warp_qp     K5's BoxQP whole on every lane of the warp (boxqp_group and
                 the gains' solve after it, the earlier design): the row-split
                 boxqp_rows against it
  k5_trials1     boxqp_rows tries one step length a pass (group 0, the
                 next only where it fails), not four at once on 28 lanes
  k5_trials2     two a pass
  k5_factor_unrolled the masked factor's column loop unrolled (a copy of
                 its code a column), not one copy run a column at a time
  k5_factor_in_registers the factor read into registers once it is made,
                 the solves reading those, not the exchange
  k5_gains_apart the gains' solve a copy of its own after the QP, not the
                 Newton steps' code run once more
  k5_div_branch  the solves' quotients by div0's branch too (a zero dividend
                 over a regular divisor multiplies, the rest divide), not by
                 div0_sel's select around a division that always runs
  k5_factor_select the factor's quotients by div0_sel too
  k5_div_special the solves' quotients and the factor's roots with their
                 special cases (non-finite operands, a zero divisor, a
                 negative root) by selects, the operation itself on finite
                 operands, so that no lane takes its slow path for them
  k5_one_pass    the five trials in one pass (groups 0-3 the first four,
                 every lane the fifth beside), no second pass where the
                 first four fail
  k5_solve_rolled the triangular solves a loop each (one division a loop,
                 the others' terms masked), not unrolled
  k5_warp_staging each warp of K5's block stages its own scenario's knot
                 and meets only its own lanes at a knot, not the block's
  wide_threads32 blocks of one warp, K4's and K5's (a launch of its own)
  k5_approx      __fdividef and x * rsqrtf(x) for the QP's divisions and
                 square roots in f32: a floor for what IEEE division costs
                 there (inexact)
  k5_factor_twice the masked factor run twice, one copy of its code in a
                 loop (the second pass runs code just run)
  k5_factor_copy  the same by two copies of its code one after the other
                 (the second runs code that the knot has not run yet)

``--iterate`` adds K5 on a solve's iterate: the arguments of its last
launch in a 3-pass sevendof_box lane solve (seed 8; the tree's kernels are
built for it while the variants compile), most of whose lanes diverge;
also on its lanes that end ok alone, on its failing lanes alone, and with
Luu NaN on every lane (a QP on non-finite values everywhere).
K5's base and k5_warp_qp also run at qp_iters 0, 1, 2, 4 and 8. ``--only``
builds and times the variants named (and base); ``--sass`` prints each
variant's static SASS opcode counts of the (28, 7) instances (cuobjdump).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import time
from pathlib import Path

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
    "threads256": _threads(256),
}
# K5 at (28, 7): the call of the parent's BoxQP (boxqp_group, whole on every
# lane, and the gains' solve after it) in place of boxqp_rows'
_ROWS_CALL = """      const int qr = qp_row<NU>();
      const S u_t = in[L::rUs + qr];
      S du[NU];
      // the factor in the exchange of Vxx, which nothing reads before the
      // knot's new Vxx is written
      boxqp_rows<S, NU>(quus, Qu, bx[qr] - u_t, bx[NU + qr] - u_t,
                        a.kprev ? -in[L::rKp + qr] : S(0), a.qp_iters, qxu, vxx, du, kc);
      for (int j = 0; j < NU; ++j) k[j] = -du[j];
"""
_WARP_CALL = """      const S(&H)[NU][NU] = *reinterpret_cast<const S(*)[NU][NU]>(quus);
      S low[NU], up[NU], du[NU], free[NU], Lf[NU][NU];
      for (int j = 0; j < NU; ++j) {
        const S u_t = in[L::rUs + j];
        low[j] = bx[j] - u_t;
        up[j] = bx[NU + j] - u_t;
        du[j] = a.kprev ? -in[L::rKp + j] : S(0);
      }
      boxqp_group<S, NU>(grp, H, Qu, low, up, a.qp_iters, du, free, Lf);
      for (int j = 0; j < NU; ++j) k[j] = -du[j];
      S rhs[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = qxu[i] * free[i];
      chol_solve<S, NU, true>(Lf, rhs, kc);
"""
# boxqp_rows' quotient (div0_sel's body), branch-free
_SEL = ("  const bool skip = a == S(0) && b_regular;\n  const S q = (skip ? S(1) : a) / b;\n"
        "  return skip ? a * b : q;\n")
_FACTOR = "      factor_rows<S, N>(h, fm, i, l, Lsm);\n"
_COLUMNS = "#pragma unroll 1\n  for (int k = 0; k < N; ++k) {"
_LIK = "div0<true>(i > k ? a[0] : S(0), d, regular(d))"
# the trials' passes of boxqp_rows, and all five trials in one pass (groups
# 0-3 four of them, every lane the fifth beside)
_PASSES = (
    '#pragma unroll 1\n'
    '    for (int p = 0; p < PASSES; ++p) {\n'
    "      const int s = p * TPP + g;  // this group's trial\n"
    '      const bool tries = g < TPP && s < NTRIAL;\n'
    '      const double a = 1.0 / (1 << (tries ? s : 0));\n'
    '      const S xai = dclip(xi + S(a) * dxi, lo, hi);\n'
    '      S xa[N];\n'
    '#pragma unroll\n'
    '      for (int j = 0; j < N; ++j) xa[j] = wshfl(xai, base + j);\n'
    '      S hxa;\n'
    '      const S fa = quad_rows<S, N>(h, q, xa, base, hxa);\n'
    '      const unsigned passed =\n'
    '          __ballot_sync(kFullWarp, tries && l == base && fa - f0 <= S(0.1 * a) * gdx);\n'
    "      if (passed) {  // the first trial that passed: its group's first lane\n"
    '        const int w = __ffs(passed) - 1;\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < N; ++j) x[j] = wshfl(xa[j], w);\n'
    '        xi = wshfl(xai, w + i);\n'
    '        hx = wshfl(hxa, w + i);\n'
    '        f0 = wshfl(fa, w);\n'
    '        break;\n'
    '      }\n'
    '    }\n'
)
_ONE_PASS = (
    '    {  // groups 0-3 try step lengths 1 .. 1/8, every lane also 1/16\n'
    '      const bool tries = g < TPP;\n'
    '      const double a = 1.0 / (1 << (tries ? g : 0));\n'
    '      const S xai = dclip(xi + S(a) * dxi, lo, hi), x4i = dclip(xi + S(0.0625) * dxi, lo, hi);\n'
    '      S xa[N], x4[N];\n'
    '#pragma unroll\n'
    '      for (int j = 0; j < N; ++j) {\n'
    '        xa[j] = wshfl(xai, base + j);\n'
    '        x4[j] = wshfl(x4i, j);\n'
    '      }\n'
    '      S hxa, hx4;\n'
    '      const S fa = quad_rows<S, N>(h, q, xa, base, hxa), f4 = quad_rows<S, N>(h, q, x4, 0, hx4);\n'
    '      const unsigned passed =\n'
    '          __ballot_sync(kFullWarp, tries && l == base && fa - f0 <= S(0.1 * a) * gdx);\n'
    "      if (passed) {  // the first trial that passed: its group's first lane\n"
    '        const int w = __ffs(passed) - 1;\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < N; ++j) x[j] = wshfl(xa[j], w);\n'
    '        xi = wshfl(xai, w + i);\n'
    '        hx = wshfl(hxa, w + i);\n'
    '        f0 = wshfl(fa, w);\n'
    '      } else if (f4 - f0 <= S(0.1 * 0.0625) * gdx) {\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < N; ++j) x[j] = x4[j];\n'
    '        xi = x4i;\n'
    '        hx = hx4;\n'
    '        f0 = f4;\n'
    '      }\n'
    '    }\n'
)
# boxqp_rows' triangular solves unrolled, and rolled (one division a loop)
_SOLVE = (
    'template <class S, int N>\n'
    '__device__ inline void solve_rows(const S (&L)[N][N], const S* b, S* x) {\n'
    '  bool reg[N];\n'
    '#pragma unroll\n'
    '  for (int i = 0; i < N; ++i) reg[i] = regular(L[i][i]);\n'
    '  S y[N];\n'
    '#pragma unroll\n'
    '  for (int i = 0; i < N; ++i) {\n'
    '    S s = b[i];\n'
    '#pragma unroll\n'
    '    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];\n'
    '    y[i] = div0_sel(s, L[i][i], reg[i]);\n'
    '  }\n'
    '#pragma unroll\n'
    '  for (int i = N - 1; i >= 0; --i) {\n'
    '    S s = y[i];\n'
    '#pragma unroll\n'
    '    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];\n'
    '    x[i] = div0_sel(s, L[i][i], reg[i]);\n'
    '  }\n'
    '}\n'
)
_SOLVE_ROLLED = (
    'template <class S, int N>\n'
    '__device__ inline void solve_rows(const S (&L)[N][N], const S* b, S* x) {\n'
    '  S bb[N], y[N], xx[N];\n'
    '#pragma unroll\n'
    '  for (int k = 0; k < N; ++k) {\n'
    '    bb[k] = b[k];\n'
    '    y[k] = xx[k] = S(0);\n'
    '  }\n'
    '#pragma unroll 1\n'
    '  for (int i = 0; i < N; ++i) {\n'
    '    S s = lane_pick(bb, i);\n'
    '#pragma unroll\n'
    '    for (int k = 0; k < N - 1; ++k) {\n'
    '      const S t = s - L[i][k] * y[k];\n'
    '      s = k < i ? t : s;\n'
    '    }\n'
    '    const S lii = L[i][i], yi = div0_sel(s, lii, regular(lii));\n'
    '#pragma unroll\n'
    '    for (int k = 0; k < N; ++k) y[k] = k == i ? yi : y[k];\n'
    '  }\n'
    '#pragma unroll 1\n'
    '  for (int i = N - 1; i >= 0; --i) {\n'
    '    S s = lane_pick(y, i);\n'
    '#pragma unroll\n'
    '    for (int k = 1; k < N; ++k) {\n'
    '      const S t = s - L[k][i] * xx[k];\n'
    '      s = k > i ? t : s;\n'
    '    }\n'
    '    const S lii = L[i][i], xi = div0_sel(s, lii, regular(lii));\n'
    '#pragma unroll\n'
    '    for (int k = 0; k < N; ++k) xx[k] = k == i ? xi : xx[k];\n'
    '  }\n'
    '#pragma unroll\n'
    '  for (int k = 0; k < N; ++k) x[k] = xx[k];\n'
    '}\n'
)
VARIANTS.update({
    "wide_threads64": [("riccati_box.cu", "constexpr int kWideThreads = 128;",
                        "constexpr int kWideThreads = 64;")],
    "wide_park_f32": [("riccati_box.cu", "  constexpr bool PARK = sizeof(S) == 8 || QP;",
                       "  constexpr bool PARK = true;")],
    "k5_no_park": [("riccati_box.cu", "  constexpr bool PARK = sizeof(S) == 8 || QP;",
                    "  constexpr bool PARK = sizeof(S) == 8;")],
    "k5_warp_qp": [("riccati_box.cu", _ROWS_CALL, _WARP_CALL)],
    "k5_trials1": [("boxqp.cuh", "constexpr int kQpTrialsAPass = 4;",
                    "constexpr int kQpTrialsAPass = 1;")],
    "k5_trials2": [("boxqp.cuh", "constexpr int kQpTrialsAPass = 4;",
                    "constexpr int kQpTrialsAPass = 2;")],
    "k5_factor_unrolled": [("boxqp.cuh", _COLUMNS,
                            "#pragma unroll\n  for (int k = 0; k < N; ++k) {")],
    "k5_factor_in_registers": [
        ("boxqp.cuh", "  const S(&Lf)[N][N] = *reinterpret_cast<const S(*)[N][N]>(Lsm);\n",
         "  S Lf[N][N];\n"),
        ("boxqp.cuh", _FACTOR,
         _FACTOR + "#pragma unroll\n      for (int r = 0; r < N; ++r)\n#pragma unroll\n"
                   "        for (int c = 0; c <= r; ++c) Lf[r][c] = Lsm[r * N + c];\n")],
    "k5_gains_apart": [("boxqp.cuh", "    // the Newton step's system, or after the last step the gains'\n"
                                     "    const bool last = it == iters;\n",
                        "    if (it == iters) {\n"
                        "      S rhs[N];\n"
                        "#pragma unroll\n"
                        "      for (int j = 0; j < N; ++j) rhs[j] = kr[j] * flag<S>(fm, j);\n"
                        "      chol_solve<S, N, true>(Lf, rhs, kc);\n"
                        "      break;\n"
                        "    }\n"
                        "    const bool last = false;\n")],
    "k5_div_branch": [("boxqp.cuh", _SEL, "  return div0<true>(a, b, b_regular);\n")],
    "k5_factor_select": [("boxqp.cuh", _LIK, "div0_sel(i > k ? a[0] : S(0), d, regular(d))")],
    "k5_one_pass": [("boxqp.cuh", _PASSES, _ONE_PASS)],
    # K5's warps each stage their own scenario's knot and meet only their own
    # lanes at a knot (the block of 128 threads kept); K4 as it is
    "k5_warp_staging": [
        ("riccati_box.cu",
         "  constexpr int RPT = L::THREADS / L::SPB;  // rows a pass\n"
         "  const int s = tid % L::SPB;\n",
         "  constexpr int RPT = L::QP ? 32 : L::THREADS / L::SPB;  // rows a pass\n"
         "  const int s = L::QP ? tid / 32 : tid % L::SPB;\n"),
        ("riccati_box.cu", "  for (int row = tid / L::SPB; row < rows; row += RPT)\n",
         "  for (int row = L::QP ? tid % 32 : tid / L::SPB; row < rows; row += RPT)\n"),
        ("riccati_box.cu",
         "    __syncthreads();  // knot t staged; every lane done with knot t+1's stage\n"
         "    if (t > 0) wide_stage<L>(a, stages, t - 1, b0, tid);\n",
         "    if constexpr (QP) __syncwarp();\n"
         "    else __syncthreads();  // knot t staged; every lane done with knot t+1's stage\n"
         "    if (t > 0) wide_stage<L>(a, stages, t - 1, b0, tid);\n")],
    # blocks of one warp (one scenario), K4's and K5's
    "wide_threads32": [("riccati_box.cu", "constexpr int kWideThreads = 128;",
                        "constexpr int kWideThreads = 32;")],
    "k5_solve_rolled": [("boxqp.cuh", _SOLVE, _SOLVE_ROLLED)],
    # the special cases (a or b not finite, b zero, a negative or non-finite
    # square root) by selects, the division and the root on finite operands
    "k5_div_special": [
        ("boxqp.cuh", _SEL,
         "  const bool skip = a == S(0) && b_regular, plain = finite(a) && b_regular;\n"
         "  const S q = (plain && !skip ? a : S(1)) / (b_regular ? b : S(1));\n"
         "  const S sign = S(copysign(1.0, (double)a) * copysign(1.0, (double)b));\n"
         "  const bool nan = a != a || b != b || (!finite(a) && !finite(b)) ||\n"
         "                   (a == S(0) && b == S(0));\n"
         "  const S special = nan ? S(NAN) : sign * (!finite(a) || b == S(0) ? S(INFINITY) : S(0));\n"
         "  return plain ? (skip ? a * b : q) : special;\n"),
        ("boxqp.cuh", "    const S d = dsqrt(wshfl(piv, k));",
         "    const S p = wshfl(piv, k);\n"
         "    const bool pos = p > S(0) && finite(p);\n"
         "    const S r = dsqrt(pos ? p : S(1));\n"
         "    const S d = pos ? r : (p == S(0) || p == S(INFINITY) ? p : S(NAN));")],
    "k5_approx": [("boxqp.cuh", _SEL,
                   "  if constexpr (sizeof(S) == 4) return __fdividef(a, b);\n"
                   "  return a / b;\n"),
                  ("boxqp.cuh", _LIK, "div0_sel(i > k ? a[0] : S(0), d, regular(d))"),
                  ("boxqp.cuh", "    const S d = dsqrt(wshfl(piv, k));",
                   "    const S p = wshfl(piv, k);\n"
                   "    S d;\n"
                   "    if constexpr (sizeof(S) == 4) d = p * rsqrtf(p);\n"
                   "    else d = dsqrt(p);")],
    # the masked factor run twice where it runs: by one copy of its code in a
    # loop (the second pass on code just run) or by two copies one after
    # the other (the second on code not yet run in the knot)
    "k5_factor_twice": [("boxqp.cuh", _FACTOR,
                         "#pragma unroll 1\n"
                         "      for (int rep = 0; rep < 2; ++rep) factor_rows<S, N>(h, fm, i, l, Lsm);\n")],
    "k5_factor_copy": [("boxqp.cuh", _FACTOR, _FACTOR + _FACTOR.replace("fm,", "fm ^ 0u,"))],
})
K5_WIDE = ("k5_no_park", "k5_warp_qp", "k5_trials1", "k5_trials2", "k5_factor_unrolled",
           "k5_factor_in_registers", "k5_gains_apart", "k5_div_branch", "k5_div_special",
           "k5_factor_select", "k5_one_pass", "k5_solve_rolled", "k5_warp_staging",
           "wide_threads32", "k5_approx", "k5_factor_twice", "k5_factor_copy")
EXACT += ("wide_threads64", "wide_park_f32") + tuple(n for n in K5_WIDE if n != "k5_approx")
# the variants each shape is timed in
WIDE = ("wide_threads64", "wide_park_f32") + K5_WIDE
SHAPES = {"2dof": [n for n in VARIANTS if n not in WIDE], "28x7": ["base", *WIDE]}
# the variants whose K2 / K5 run the qp_iters sweep at each shape
SWEPT = {"2dof": ("base",), "28x7": ("base", "k5_warp_qp")}


def ptxas_lines(out, pattern):
    """The ptxas report (registers, stack frame, spills) of each kernel of
    nvcc's output ``out`` whose mangled name matches ``pattern``, a line
    each: the name's kernel and template arguments, then the report."""
    lines, name, frame = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
        elif name and "stack frame" in line:
            frame = line.split(":", 1)[-1].strip()
        elif name and "Used" in line:
            short = re.sub(r"^_ZN4aslr\d+|EEEvN.*$", "", name)
            regs = line.split("Used")[1].split(",")[0].strip()
            lines.append(f"{short}: {regs}; {frame}")
            name = None
    return lines


def sass_counts(lib_path, pattern):
    """{kernel: (instructions, {opcode: count})} of the kernels of the built
    library whose mangled name matches ``pattern``, from ``cuobjdump -sass``
    (static counts: each instruction of the code once, whatever runs it)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                counts[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.\S+)?", line)
        if name and m:
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return {k: (sum(v.values()), v) for k, v in counts.items()}


def print_sass(name, lib_path):
    """Each (28, 7) instance's instruction count and the opcodes that the
    QP's chain is made of: shuffles, votes, the special-function unit
    (reciprocals, square roots), the slow paths' calls and the branches."""
    keys = ("SHFL", "VOTE", "MUFU", "FCHK", "CALL", "BRA", "BSSY", "LDS", "STS", "FMUL", "FADD",
            "FFMA", "DMUL", "DADD", "DFMA", "FSEL", "FSETP", "DSETP", "STL", "LDL")
    for kernel, (total, ops) in sass_counts(lib_path, r"riccati_(box)?fddp_kernelI[fd]Li28E").items():
        short = re.sub(r"^_ZN4aslr\d+|EEEvN.*$", "", kernel)
        print(f"  {name} sass {short}: {total} instructions; "
              + ", ".join(f"{k} {ops[k]}" for k in keys if k in ops), flush=True)


def build_variants(names, sass=False, meanwhile=None):
    """{name: loaded library}; one nvcc per variant, all at once (``sass``:
    each one's SASS counts of the (28, 7) instances printed); ``meanwhile``
    runs while they compile."""
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
    if meanwhile:
        meanwhile()
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in out.splitlines()
                if "Used" in line]
        print(f"built {name}: {', '.join(regs)}", flush=True)
        for line in ptxas_lines(out, r"riccati_(box)?fddp_kernelI[fd]Li28E"):
            print(f"  {name} {line}", flush=True)
        if sass:
            print_sass(name, root / name / "lib.so")
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


def k5_iterate(B, passes=3):
    """K5's arguments at (28, 7) in the last backward of a ``passes``-pass
    sevendof_box lane solve (seed 8) through the kernels of this tree (as
    chip_smoke's ``k5_iterate``): most of its lanes are diverging."""
    from .kernels import lane_solver
    from .measure import SEEDS, sevendof_solver, x0_batch

    seen = []
    own = lane_solver.riccati_boxfddp_backward

    def record(*args, **kwargs):
        seen[:] = [args]
        return own(*args, **kwargs)

    lane_solver.riccati_boxfddp_backward = record
    try:
        solve = sevendof_solver("sevendof_box", dtype=torch.float32, maxiter=passes)
        solve(x0_batch(B, torch.float32, SEEDS["sevendof_box"], nx=28))
    finally:
        lane_solver.riccati_boxfddp_backward = own
    torch.cuda.synchronize()
    return [a.clone() if torch.is_tensor(a) else a for a in seen[0]]


def iterate_cases(a, lib):
    """K5's cases on a solve's iterate ``a`` (k5_iterate): all its lanes,
    the lanes where K5 (``lib``'s) ends ok and those where it fails, and
    all lanes failing (Luu NaN: every QP on non-finite values)."""
    def call(args):
        return lambda it: rk.riccati_boxfddp_backward(*args[:15], it, *args[16:])

    own = build._lib
    build._lib = lib
    try:
        ok = rk.riccati_boxfddp_backward(*a).ok
    finally:
        build._lib = own
    B = ok.shape[0]

    def lanes(mask):
        return [t[..., mask].contiguous() if torch.is_tensor(t) and t.shape[-1:] == (B,) else t
                for t in a]

    nan = list(a)
    nan[6] = torch.full_like(a[6], float("nan"))
    cases = {"K5 (28, 7) iterate": (call(a), True)}
    for mask, what in ((ok, "ok"), (~ok, "failing")):
        if bool(mask.any()):
            cases[f"K5 (28, 7) iterate, {int(mask.sum())} {what} lanes"] = (call(lanes(mask)), True)
    cases["K5 (28, 7) iterate, Luu NaN"] = (call(nan), True)
    return cases


def box_inputs_n7(B, T=100, dtype=torch.float32):
    """{case: (call of qp_iters, whether it takes them)}: K4 and K5 at (28,
    7) on the 7-DoF SEA arm, on chip_smoke's n-DoF kernel-phase inputs (K5
    warm from zero kprev in the box of the sevendof_box path)."""
    from . import seven_dof_sea
    from .kernels import vsa_kernels as vk
    from .measure import SEVENDOF_BOX, x0_batch

    w = seven_dof_sea(T=T, dtype=dtype)
    spec = vk.extract_vsa_spec(w.problem, w.bounds)
    x0 = x0_batch(B, dtype, seed=0, nx=spec.ndx).T.contiguous()
    xs = x0.expand(T + 1, spec.ndx, B).contiguous()
    us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lin = vk.linearize_plain(spec, xs, us, torch.full((B,), spec.w_goal_term, dtype=dtype,
                                                       device="cuda"))
    r = lin.run
    fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
    reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
    a = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
         lin.term["Lxx"], fs, reg)
    top = torch.tensor(SEVENDOF_BOX, dtype=dtype, device="cuda")[:, None].expand(spec.nu, B)
    box = (us, torch.zeros_like(us), (-top).contiguous(), top.contiguous(), reg)
    return {"K4 (28, 7)": (lambda it: rk.riccati_fddp_backward(*a), False),
            "K5 (28, 7)": (lambda it: rk.riccati_boxfddp_backward(*a[:-1], *box, it), True)}


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
    ap.add_argument("--shape", choices=sorted(SHAPES), default="2dof",
                    help="2dof: K2, K5 and K4 on the 2-DoF arms; 28x7: K4 and K5 on the 7-DoF "
                         "arm")
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS opcode counts of the (28, 7) instances")
    ap.add_argument("--only", nargs="+", help="build and time only these variants (and base)")
    ap.add_argument("--iterate", action="store_true",
                    help="28x7: K5 also on a 7-DoF box lane solve's iterate (builds the tree's "
                         "kernels for the solve)")
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batches (default 4096 16384; 1024 4096 at 28x7)")
    args = ap.parse_args(argv)
    batches = args.batch or ([4096, 16384] if args.shape == "2dof" else [1024, 4096])
    inputs = box_inputs if args.shape == "2dof" else box_inputs_n7
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    names = SHAPES[args.shape]
    if args.only:
        unknown = set(args.only) - set(names)
        if unknown:
            raise SystemExit(f"no such variant at {args.shape}: {sorted(unknown)}")
        names = [n for n in names if n == "base" or n in args.only]
    iterates = {}

    def capture():
        for B in batches:
            iterates[B] = k5_iterate(B)

    libs = build_variants(names, sass=args.sass,
                          meanwhile=capture if args.iterate and args.shape == "28x7" else None)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    own = build._lib
    try:
        for B in batches:
            cases = inputs(B)
            if B in iterates:
                cases.update(iterate_cases(iterates[B], libs["base"]))
            for kernel, (fn, takes_qp) in cases.items():
                build._lib = libs["base"]
                want = fn(2)
                if kernel.endswith("iterate"):
                    luu = torch.isfinite(iterates[B][6]).flatten(0, 2).all(0)
                    print(f"{kernel} B={B}: ok on {int(want.ok.sum())} of {B} lanes, Luu finite "
                          f"on {int(luu.sum())}", flush=True)
                if "ok lanes" in kernel and not bool(want.ok.all()):
                    raise AssertionError(f"{kernel}: not every lane ok")
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
                swept = takes_qp and not kernel.startswith("K5 (28, 7) iterate,")
                for name in [n for n in SWEPT[args.shape] if n in libs] if swept else ():
                    build._lib = libs[name]
                    sweep = [f"{it}: {cuda_ms(lambda: fn(it)):.4f}" for it in (0, 1, 2, 4, 8)]
                    print(f"{kernel} {name} B={B} ms by qp_iters: " + ", ".join(sweep),
                          flush=True)
    finally:
        build._lib = own


if __name__ == "__main__":
    main()
