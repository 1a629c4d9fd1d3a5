"""Drive the PyTorch port's solver paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and time:
  1. device: a CUDA card must be present (else exit 2); its name and power
     limit as nvidia-smi reports them;
  2. build: one nvcc per aslr_to_tpu_torch/csrc/*.cu for sm_90a, all at
     once (-Xptxas -v), then the link; for every instantiation of K1, of the
     Riccati group kernel (K2, K4, K5) and of the rollouts (K3, K6) its
     registers, stack frame, spills and dynamic shared memory;
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes (T=100, B=4096): float64 to a relative error of 1e-9
     with equal flags, float32 reported; K1, K3, K4 and K6 to the bit in
     both, and K6 equal to K3's first trial at the same step length; kernel
     and plain times from CUDA events after a warm-up; the least time the
     card could take for the same work (bytes over 3.35 TB/s against
     arithmetic operations over 67 TFLOP/s f32). K1 runs its VSA and SEA
     variants, K3 and K6 their box, unbounded and SEA-gap variants, K4 the
     SEA (nu 2) and VSA (nu 4) shapes with gaps, K5 the VSA shape; K1, K2,
     K4, K5, K3 and K6 also time f32 at B=16384, kernel only, to show
     whether they fill the card;
     probe: P (aslr_to_tpu_torch/probe.py) in each configuration (ilp 1,
     2, 4, 8; B 65536, 1048576; mul+add and fma) against its plain
     version, with its time, GFLOP/s and bound;
     n-DoF kernels: the launch of K6, K3 and K1 at nl 7 and of K4 at
     (28, 7) (their own layouts; K3's picked by the batch) at B=1024 and
     4096 in f32 and f64 (grid, threads a block, dynamic shared memory,
     the blocks resident an SM by
     cudaOccupancyMaxActiveBlocksPerMultiprocessor) with each one's ptxas
     line; K1, K4, K3 and K6 at the 3- and 7-DoF SEA arms' instances (nl 3
     and 7; K4 at (12, 3) and (28, 7); the rollouts unboxed with gaps)
     against their plain versions to the bit in f64 and f32 at T=100,
     B=1024 (K6 also against K3's first trial), timed in f32 there and at
     B=4096 (K3 at nl 7, in its other layout there, first held to the bit
     again in f64 and f32), with the plain version's time at B=1024 and
     the bound;
  4. main path: BoxDDP, make_batched_solver(..., use_fast_path="lanes") on
     two_dof_vsa_boxddp, T=100, B=4096, float32, maxiter=20;
  5. SEA warm: FDDP on two_dof_sea, T=100, B=4096, float32, maxiter=60,
     th_stop=1e-5: one cold solve, then two timed warm re-solves from its
     (xs, us) with x0s + 1e-4 (i + 1) (bench.py:180-200);
  6. BoxFDDP: two_dof_vsa_boxddp with gaps and the preset's box, T=100,
     B=4096, float32, maxiter=20;
     (phases 4-6 take their paths, inputs and seeds from
     aslr_to_tpu_torch/measure.py; each solve, the cold one included, is
     driven with the launch counters reset just before it and read just
     after, and every kernel of the path must have launched in it; a
     kernel row's launches are those of one timed solve);
  7. parity, float64, kernel backend against the plain backend lane by
     lane: BoxDDP and SEA FDDP (B=256, T=100, maxiter 20), BoxFDDP in a
     tight box (B=128, T=40, maxiter 10);
  8. golden: the T=30 BoxDDP solve against tests/golden/vsa_boxddp_T30.npz
     and the quasi-static-warm T=100 SEA FDDP solve against
     tests/golden/sea_T100.npz, both float64 through the kernels;
  9. 7-DoF: FDDP on seven_dof_sea (nx=28, nu=7), B=1024, T=100, float32,
     warm-started from the quasi-static controls, maxiter=20, th_stop=1e-5
     (bench.py:231-252): the lane route (K1, K4, K3 at nl = 7), two timed
     solves with solves/s and the convergence accounting beside the TPU's
     converged fraction; the fast route (K1, K4, K6) on the same inputs,
     within 3 points (1.5 mean iterations) of the lane route; the generic
     route in float64 at T=10, B=16, maxiter=3 against both (at least B-1
     lanes agree);
 10. fast path: the per-scenario solver's fused route,
     make_batched_solver(..., use_fast_path=True) (K1, the Riccati kernel,
     K6 one trial a line-search round), on the BoxDDP main path's inputs
     and on the SEA cold solve's (measure.py paths fast_boxddp, fast_sea),
     T=100, B=4096, f32; its convergence statistics must land within 3
     points (1.5 mean iterations) of the lane path's on the same inputs;
 11. per-knot kernels: the per-knot table variants against their plain
     versions to the bit in f64 and f32 at their paths' shapes (K1, K3 and
     K6 with the tracking MPC's [T, 12] target table, T=60, B=2048; K2, K5,
     K3 and K6 with pk_boxddp's [T, 4] box tables, T=100, B=4096), timed in
     f32 there and at B=16384 (the kernel's device time by torch.profiler,
     since at the MPC's shapes a launch is shorter than its wrapper's host
     time, with the CUDA events' time beside; the plain version; the bound
     with the tables' bytes); tables of equal rows against the shared route
     to the bit, and timed (the tables' own cost on the same data);
 12. per-knot: the tracking MPC of examples/mpc_tracking.py (measure.py
     paths mpc_tracking and fast_mpc_tracking: T=60, B=2048, f32,
     maxiter=30; a first solve, then three timed solves at x0s + 1e-4
     (i + 1)) with solves/s and the convergence accounting, the fast route
     within 3 points of the lane route, the converged share beside the
     TPU's 99.7%; pk_boxddp (the pinched-box BoxDDP, T=100, B=4096), whose
     pinched knots must clamp; f64 parity of each per-knot route against
     its plain backend (B=64, maxiter 6: the MPC at T=60, BoxDDP, BoxFDDP
     and fast BoxDDP in the pinched box at T=40), at least B-1 lanes
     agreeing; the generic route against the lanes in f64 at T=20, B=16
     (the MPC and the pinched BoxDDP), at least B-1 lanes agreeing;
 13. generic: the generic solver (use_fast_path=False, the reference),
     the fast path and the lane path in float64 at T=40, B=64, maxiter=20
     (BoxDDP in the tight box with cold QPs, SEA FDDP), at least B-1 lanes
     equal in iterations and flags with cost within rtol 1e-8 (a lane
     diverged in both excepted) pairwise, a lane whose generic and fast
     logs part re-run to the parting with the controls that sit on a
     bound in one route only printed; one timed f32 solve of each
     route at T=100, B=256 with the main path's settings and maxiter=2
     (BoxDDP); the T=30 BoxDDP golden through SolverBoxDDP.

Phases 7 and 13 solve on the plain backend and the generic route, whose
thousands of small kernels a loop pass wait on the host and leave the card
idle. So once the timed phases are done, they run in worker processes of
their own (``python3 chip_smoke.py --check NAME ...``, CHECK_WORKERS),
side by side with each other and with the checks of phase 12 and phase 8
in this process, which then prints each worker's output and fails if a
worker failed; 13's timed solves and its golden run before, alone.

Any failed check raises, so the script exits non-zero. The line before the
card's line is the kernel table as JSON; the last line is the device
record.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# the TPU's f32 statistics (the JAX package's benchmark record
# BENCH_r05.json), printed beside the card's for reference only
TPU_REFERENCE = dict(boxddp=dict(converged_frac=0.0, diverged_frac=0.211, mean_iterations=18.4),
                     sea_warm=dict(converged_frac=0.9998),
                     sevendof=dict(converged_frac=0.9316, solves_per_s_on_tpu=1984.58))
KERNELS = {
    "linearize": dict(source="aslr_to_tpu_torch/csrc/linearize.cu",
                      replaces="aslr_to_tpu/pallas/vsa_kernels.py:797"),
    "riccati_box": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                        replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "rollout2": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                     replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "riccati_fddp": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                         replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "riccati_boxfddp": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                            replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "rollout1": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                     replaces="aslr_to_tpu/pallas/vsa_kernels.py:430"),
    "probe": dict(source="aslr_to_tpu_torch/csrc/probe.cu",
                  replaces="scripts/probe_sublane.py:40"),
    # the 7-DoF SEA arm's instances (nl = 7; K4 at (28, 7)); the 3-DoF ones
    # are their rows' variants
    "linearize_n7": dict(source="aslr_to_tpu_torch/csrc/linearize_n7.cu",
                         replaces="aslr_to_tpu/pallas/vsa_kernels.py:797"),
    "riccati_fddp_n7": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                            replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "rollout2_n7": dict(source="aslr_to_tpu_torch/csrc/rollout_n7.cu",
                        replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "rollout1_n7": dict(source="aslr_to_tpu_torch/csrc/rollout_n7.cu",
                        replaces="aslr_to_tpu/pallas/vsa_kernels.py:430"),
    # the per-knot table variants: K1, K3 and K6 with the [T, 12] target
    # table (the tracking MPC, 2-DoF SEA), K2, K5, K3 and K6 with [T, nu] box
    # tables (the pinched box, 2-DoF VSA)
    "linearize:target_table": dict(source="aslr_to_tpu_torch/csrc/linearize.cu",
                                   replaces="aslr_to_tpu/pallas/vsa_kernels.py:797"),
    "rollout2:target_table": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                                  replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "rollout1:target_table": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                                  replaces="aslr_to_tpu/pallas/vsa_kernels.py:430"),
    "riccati_box:box_table": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                              replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "riccati_boxfddp:box_table": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                                  replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "rollout2:box_table": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                               replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "rollout1:box_table": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                               replaces="aslr_to_tpu/pallas/vsa_kernels.py:430"),
}
# the case each kernel's row is timed on, and the path its launches come
# from; the other cases of a kernel are reported as its variants
ROW_CASE = ("linearize[vsa]", "riccati_box[vsa]", "rollout2[vsa box]", "riccati_fddp[sea]",
            "riccati_boxfddp[vsa]", "rollout1[vsa box]")
# P is on no solver path: its launches are those of the probe phase
ROW_PATH = {"linearize": "boxddp", "riccati_box": "boxddp", "rollout2": "boxddp",
            "riccati_fddp": "sea_warm", "riccati_boxfddp": "boxfddp",
            "rollout1": "fast_boxddp", "probe": "probe", "linearize_n7": "sevendof",
            "riccati_fddp_n7": "sevendof", "rollout2_n7": "sevendof",
            "rollout1_n7": "fast_sevendof", "linearize:target_table": "mpc_tracking",
            "rollout2:target_table": "mpc_tracking", "rollout1:target_table": "fast_mpc_tracking",
            "riccati_box:box_table": "pk_boxddp", "rollout2:box_table": "pk_boxddp",
            "riccati_boxfddp:box_table": "pk_parity_boxfddp",
            "rollout1:box_table": "pk_parity_fast_boxddp"}
# the launch counter (build.LAUNCHES) of each row, and the paths that run
# the 7-DoF instances and the per-knot tables
ROW_KERNEL = {row: row.split(":")[0].removesuffix("_n7") for row in ROW_PATH}
NDOF_PATHS = ("sevendof", "fast_sevendof")
TABLE_ROWS = tuple(row for row in ROW_PATH if ":" in row)
PK_PATHS = ("mpc_tracking", "fast_mpc_tracking", "pk_boxddp", "pk_parity_mpc",
            "pk_parity_boxddp", "pk_parity_boxfddp", "pk_parity_fast_boxddp")
# the per-knot phase: the TPU's converged share of the tracking MPC at
# MPC_BATCH=2048 (docs/BENCH.md:449-451), a cross-check only; parity and
# the generic route's check at small sizes
TPU_MPC_CONVERGED = 0.997
B_PK_PARITY, MAXITER_PK_PARITY, T_PK_PARITY_BOX = 64, 6, 40
# the row of each equal-rows check (its kernel with the tables)
EQUAL_ROWS_ROW = {"linearize[sea]": "linearize:target_table",
                  "rollout2[sea gaps]": "rollout2:target_table",
                  "rollout1[sea gaps]": "rollout1:target_table",
                  "riccati_box[vsa]": "riccati_box:box_table",
                  "riccati_boxfddp[vsa]": "riccati_boxfddp:box_table",
                  "rollout2[vsa box]": "rollout2:box_table",
                  "rollout1[vsa box]": "rollout1:box_table"}
T_PK_GENERIC, B_PK_GENERIC, MAXITER_PK_GENERIC = 20, 16, 10
B_NDOF = 1024                      # the 7-DoF path's batch (measure.B_SEVENDOF)
T_NDOF_GENERIC, B_NDOF_GENERIC, MAXITER_NDOF_GENERIC = 10, 16, 3
# the cases also timed at B_FILL
FILL_CASE = ROW_CASE + ("linearize[sea]", "riccati_fddp[vsa]")
# kernels held to their plain versions to the bit (the others to 1e-9 in f64)
BIT_EXACT = ("linearize", "riccati_fddp", "rollout2", "rollout1")
PROBE_ROW = dict(B=1048576, ilp=1, mode="mul_add")
NO_LIBRARY = ("no single PyTorch call computes this function (a serial per-scenario "
              "recursion); no stand-in timed")
# BoxDDP and SEA FDDP parity at the main path's depth (measure.T_PATH)
B_PARITY, B_PARITY_BOX, T_PARITY_BOX = 256, 128, 40
T_GENERIC, B_GENERIC, B_TIMED, MAXITER_TIMED = 40, 64, 256, 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
REG = 1e-9
B_FILL = 16384                     # the kernels' batch-filling variant


def log(msg):
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            log(f"[{name}] ok in {time.perf_counter() - t0:.3f} s")
            return out
        return run
    return wrap


def rel_err(a, b):
    """Per-lane normwise relative error, max over lanes of
    max|a - b| / max|b| within the lane (the last axis), over the elements
    finite in both; a lane finite in one and not in the other is an
    infinite error. Returns (relative, absolute) maxima."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    lane_fa = fa.reshape(-1, a.shape[-1]).all(0)
    lane_fb = fb.reshape(-1, b.shape[-1]).all(0)
    if not torch.equal(lane_fa, lane_fb):
        return float("inf"), float("inf")
    both = fa & fb
    d = torch.where(both, (a - b).abs(), 0.0).reshape(-1, a.shape[-1]).amax(0)
    scale = torch.where(both, b.abs(), 0.0).reshape(-1, b.shape[-1]).amax(0)
    rel = torch.where(d > 0, d / scale.clamp_min(1e-300), 0.0)
    return float(rel.max()), float(d.max())


def cuda_ms(fn, reps):
    fn()                                    # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel):
    """The device time of one launch of ``kernel`` (a kernel function's
    name, e.g. "rollout2_kernel") in ``fn``, by torch.profiler over ``reps``
    calls after a warm-up: the host's launch overhead, which the CUDA events
    of :func:`cuda_ms` count where a launch is shorter than it, left out.
    The tracer can drop the first records of a window, so each window
    opens with a launch of its own, waited for before the timed calls. A
    profile that still lost launches of the kernel is taken again, up to
    three times in all; if none holds every launch, the mean of the
    fullest one's launches is taken and the loss logged. Raises if a
    profile holds more launches than calls, or none holds any."""
    from torch.profiler import ProfilerActivity, profile

    from aslr_to_tpu_torch.measure import _device_us

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    counts, fullest = [], (0, 0.0)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and kernel in evt.key:
                us += _device_us(evt)
                n += evt.count
        if n > reps:
            raise AssertionError(f"a profile holds {n} launches of {kernel} in {reps} calls")
        if n == reps:
            return us / 1e3 / n
        counts.append(n)
        fullest = max(fullest, (n, us))
    n, us = fullest
    if n == 0:
        raise AssertionError(f"the profiles hold no launch of {kernel} in {reps} calls")
    log(f"  {kernel}: the profiles hold {counts} launches of {reps}; the mean of the "
        f"{n} in the fullest taken")
    return us / 1e3 / n


_ARITH = {"add", "sub", "mul", "div", "neg", "sqrt", "sin", "cos", "atan2", "abs",
          "maximum", "minimum", "__add__", "__radd__", "__iadd__", "__sub__", "__rsub__",
          "__mul__", "__rmul__", "__truediv__", "__rtruediv__", "__neg__"}


class _OpCount(TorchFunctionMode):
    """Counts the elementwise arithmetic operations (add, sub, mul, div,
    neg, abs, min, max, sqrt, sin, cos, atan2: one each per element) that a
    plain version performs. The plain versions follow their kernels'
    operations lane for lane, so this is the kernel's operation count on
    these inputs."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in _ARITH and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn):
    with _OpCount() as counter:
        fn()
    return counter.ops


def io_values(name, T, ndx, nu, boxed=False, warm=False, gaps=False):
    """Values per scenario that a kernel must read (each input once) and
    write (each output once), from its shapes; flags count one byte each
    and are returned apart."""
    derivs = T * (2 * ndx * ndx + 2 * ndx * nu + nu * nu + ndx + nu) + ndx + ndx * ndx
    if name == "linearize":
        return ((T + 1) * ndx + T * nu + 1,
                T * (2 * ndx * ndx + 2 * ndx * nu + nu * nu + 2 * ndx + nu + 1)
                + ndx + ndx * ndx + 1, T + 1)
    if name == "riccati_box":
        return (derivs + T * nu * (2 if warm else 1) + 2 * nu + 1, T * (nu + nu * ndx) + 3, 2)
    if name in ("riccati_fddp", "riccati_boxfddp"):
        extra = (T * nu * (2 if warm else 1) + 2 * nu) if boxed else 0
        return (derivs + (T + 1) * ndx + extra + 1,
                T * (nu + nu * ndx) + (T + 1) * ndx + 5, 2)
    if name in ("rollout2", "rollout1"):
        trials = 2 if name == "rollout2" else 1
        inputs = T * ndx + 2 * T * nu + T * nu * ndx + ndx + 1 + trials
        inputs += (2 * nu if boxed else 0) + ((T + 1) * ndx + 1 if gaps else 0)
        return inputs, trials * ((T + 1) * ndx + T * nu + 1), 0
    raise KeyError(name)


def bound(ops, n_in, n_out, n_flags, B, itemsize, table_bytes=0):
    """(bound_ms, bound_by, bytes): the least time for the work; the
    per-knot tables, read once for the whole batch, add ``table_bytes``."""
    nbytes = (n_in + n_out) * B * itemsize + n_flags * B + table_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on a GPU only")
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    # the plain versions use no matmul, but state the precision anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


@phase("build")
def build_phase():
    from aslr_to_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(force=True)
    build.lib()
    log(f"built {path.name} in {time.perf_counter() - t0:.3f} s; nvcc seconds by source: "
        + ", ".join(f"{k} {v:.1f}" for k, v in build.build_seconds.items()))
    for line in build.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "== ")):
            log(f"  ptxas: {line.strip()}")
    for line in kernel_ptxas(build.build_log, build.lib()):
        log(f"  {line}")


# the label of each table mode (csrc/common.cuh::TableMode) of an instance
TABLE_MODES = {"0": "", "1": " tables", "2": " either"}


def kernel_ptxas(build_log, lib):
    """One line per instantiation of K1, of the Riccati group kernel (K2, K4,
    K5) and of the rollouts (K3, K6): registers, stack frame and spills from
    ptxas, and a block's dynamic shared memory."""
    def box(kind, s, ndx, nu, g):
        size = 4 if s == "f" else 8
        smem = (lib.aslr_riccati_fddp_smem(int(ndx), int(nu), size) if kind == "fddp" else
                lib.aslr_riccati_box_smem(int(nu), int(kind == "boxfddp"), size))
        return f"{dict(box='K2', boxfddp='K5', fddp='K4')[kind]} {{}} (ndx {ndx}, nu {nu}, " \
               f"{g} lanes a scenario)", smem

    def roll(nt, s, nl, sea, boxed, gaps, tab, wide):
        # K3's layout where it has two (nl 7): " wide" or " general"
        layout = "" if wide is None or int(nl) + 1 <= 4 else (" wide" if wide == "1" else
                                                               " general")
        return (f"{'K3' if nt == '2' else 'K6'} {{}} nl {nl} {'SEA' if sea == '1' else 'VSA'}"
                f"{' box' if boxed == '1' else ''}{' gaps' if gaps == '1' else ''}"
                f"{TABLE_MODES[tab]}{layout}",
                lib.aslr_rollout_smem(int(nl), int(nt), int(sea), int(gaps), int(wide == "1"),
                                      4 if s == "f" else 8))

    def lin(s, nl, sea, tab):
        # the group tiles of the wide layout (nl 7), by its launch query
        smem = 0
        if nl == "7":
            out = (ctypes.c_int * 5)()
            if lib.aslr_linearize_n7_launch(4 if s == "f" else 8, 1, 1, out) != 0:
                raise AssertionError("K1 nl 7: the launch query failed")
            smem = out[2]
        return f"K1 {{}} nl {nl} {'SEA' if sea == '1' else 'VSA'}{TABLE_MODES[tab]}", smem

    kinds = [(r"linearize_kernelI([fd])Li(\d+)ELb([01])ELi(\d)E", lin, 0),
             (r"riccati_(box|boxfddp|fddp)_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)E", box, 1),
             (r"rollout([12])_kernelI([fd])Li(\d+)ELb([01])ELb([01])ELb([01])ELi(\d)E"
              r"(?:Lb([01])E)?", roll, 1)]
    lines, name, frame = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = None
            for pattern, describe, at in kinds:
                m = re.search(pattern, line)
                if m:
                    label, smem = describe(*m.groups())
                    name = label.format("f32" if m.group(at + 1) == "f" else "f64"), smem
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            lines.append(f"{name[0]}: {regs}; {frame}; dynamic shared memory {name[1]} bytes")
            name = None
    return lines


def tight_box(dtype):
    from aslr_to_tpu_torch import Bounds

    def t(v):
        return torch.tensor(v, dtype=dtype, device="cuda")

    return Bounds(t([-2.0, -2.0, 0.0, 0.0]), t([2.0, 2.0, 3.0, 3.0]))


def kernel_cases(dtype, B=None, arms=("vsa", "sea"), T=None):
    """{row: (kernel call, plain call, io_values kwargs, name, ndx, nu)} at
    the paths' shapes (T=100, B=4096 unless given). Arms: the 2-DoF VSA and
    SEA arms, and the 3- and 7-DoF SEA arms (sea3, sea7)."""
    from aslr_to_tpu_torch import seven_dof_sea, three_dof_sea, two_dof_sea, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk
    from aslr_to_tpu_torch.measure import B_PATH, T_PATH, x0_batch

    B, T = B or B_PATH, T or T_PATH
    presets = dict(vsa=two_dof_vsa_boxddp, sea=two_dof_sea, sea3=three_dof_sea,
                   sea7=seven_dof_sea)
    cases = {}
    for arm in arms:
        w = presets[arm](T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        nu, ndx = spec.nu, spec.ndx
        x0 = x0_batch(B, dtype, seed=0, nx=ndx).T.contiguous()
        xs = x0.expand(T + 1, ndx, B).contiguous()
        if arm != "vsa":        # the warm start's quasi-static controls
            us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        else:
            us = torch.zeros(T, nu, B, dtype=dtype, device="cuda")
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
        lin = vk.linearize_plain(spec, xs, us, wterm)
        r = lin.run
        derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                  lin.term["Lx"], lin.term["Lxx"])
        fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
        # f64: a few lanes at a negative reg, so the flags go both ways; the
        # f32 pass, which is timed, keeps every lane at the solver's reg
        reg = torch.full((B,), REG, dtype=dtype, device="cuda")
        if dtype == torch.float64:
            reg[::512] = -5.0
        ones = torch.ones(B, dtype=dtype, device="cuda")
        lin_args = (spec, xs, us, wterm)
        cases[f"linearize[{arm}]"] = (lambda a=lin_args: vk.linearize(*a),
                                      lambda a=lin_args: vk.linearize_plain(*a),
                                      dict(), "linearize", ndx, nu)
        if arm == "vsa":
            lb = torch.as_tensor(spec.lb, dtype=dtype, device="cuda")[:, None].expand(nu, B)
            ub = torch.as_tensor(spec.ub, dtype=dtype, device="cuda")[:, None].expand(nu, B)
            lb, ub = lb.contiguous(), ub.contiguous()
            kprev = torch.zeros(T, nu, B, dtype=dtype, device="cuda")
            box_args = derivs + (us, kprev, lb, ub, reg, 2)
            cases["riccati_box[vsa]"] = (lambda a=box_args: rk.riccati_box_backward(*a),
                                         lambda a=box_args: rk.riccati_box_plain(*a),
                                         dict(warm=True), "riccati_box", 8, nu)
            fd_args = derivs + (fs, reg)
            cases["riccati_fddp[vsa]"] = (lambda a=fd_args: rk.riccati_fddp_backward(*a),
                                          lambda a=fd_args: rk.riccati_fddp_plain(*a),
                                          dict(), "riccati_fddp", 8, nu)
            bf_args = derivs + (fs, us, kprev, lb, ub, reg, 2)
            cases["riccati_boxfddp[vsa]"] = (
                lambda a=bf_args: rk.riccati_boxfddp_backward(*a),
                lambda a=bf_args: rk.riccati_boxfddp_plain(*a),
                dict(boxed=True, warm=True), "riccati_boxfddp", 8, nu)
            bw = rk.riccati_box_plain(*box_args)
            roll_args = (spec, xs, us, bw.k, bw.K, x0, ones, 0.5 * ones, wterm, lb, ub)
            cases["rollout2[vsa box]"] = (lambda a=roll_args: vk.rollout2(*a),
                                          lambda a=roll_args: vk.rollout2_plain(*a),
                                          dict(boxed=True), "rollout2", 8, nu)
            free_args = roll_args[:9] + (None, None)
            cases["rollout2[vsa unbounded]"] = (lambda a=free_args: vk.rollout2(*a),
                                                lambda a=free_args: vk.rollout2_plain(*a),
                                                dict(), "rollout2", 8, nu)
            # K6 at the second trial's step lengths, then without the box
            for label, r1 in (("rollout1[vsa box]", roll_args[:6] + roll_args[7:]),
                              ("rollout1[vsa unbounded]", free_args[:6] + free_args[7:])):
                cases[label] = (partial(vk.rollout1, *r1), partial(vk.rollout1_plain, *r1),
                                dict(boxed=label.endswith("box]")), "rollout1", 8, nu)
        else:
            fd_args = derivs + (fs, reg)
            cases[f"riccati_fddp[{arm}]"] = (lambda a=fd_args: rk.riccati_fddp_backward(*a),
                                             lambda a=fd_args: rk.riccati_fddp_plain(*a),
                                             dict(), "riccati_fddp", ndx, nu)
            bw = rk.riccati_fddp_plain(*fd_args)
            k = torch.where(bw.ok, bw.k, 0.0)
            K = torch.where(bw.ok, bw.K, 0.0)
            # feasible and infeasible lanes: a feasible lane contracts nothing
            infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
            roll_args = (spec, xs, us, k, K, x0, ones, 0.5 * ones, wterm, None, None,
                         fs, infeas)
            cases[f"rollout2[{arm} gaps]"] = (lambda a=roll_args: vk.rollout2(*a),
                                              lambda a=roll_args: vk.rollout2_plain(*a),
                                              dict(gaps=True), "rollout2", ndx, nu)
            r1 = roll_args[:6] + roll_args[7:]
            cases[f"rollout1[{arm} gaps]"] = (partial(vk.rollout1, *r1),
                                              partial(vk.rollout1_plain, *r1),
                                              dict(gaps=True), "rollout1", ndx, nu)
    return cases


def flat(out):
    if hasattr(out, "run"):
        return ({f"run.{k}": v for k, v in out.run.items()}
                | {f"term.{k}": v for k, v in out.term.items()}
                | dict(cost=out.cost, xnext=out.xnext, ok=out.ok))
    if hasattr(out, "retryable"):
        return out._asdict()
    if hasattr(out, "cost"):                    # one Trial (K6)
        return out._asdict()
    return {f"trial{i}.{f}": getattr(t, f) for i, t in enumerate(out)
            for f in ("xs", "us", "cost")}


def compare(name, got, want, tol):
    worst_rel, worst_abs = 0.0, 0.0
    got_f = flat(got)
    for key, w in flat(want).items():
        g = got_f[key]
        if w.dtype == torch.bool:
            n_diff = int((g != w).sum())
            if tol is not None and n_diff:
                raise AssertionError(f"{name}.{key}: flags differ in {n_diff} lanes")
            continue
        r, d = rel_err(g, w)
        worst_rel, worst_abs = max(worst_rel, r), max(worst_abs, d)
        if tol is not None and not r <= tol:
            raise AssertionError(f"{name}.{key}: relative error {r:.3e} > {tol:g}")
    return worst_rel, worst_abs


@phase("kernels")
def kernels_phase(report):
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import B_PATH, T_PATH

    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, None)):
        tag = "f64" if dtype == torch.float64 else "f32"
        for label, (kern, plain, io_kw, name, ndx, nu) in kernel_cases(dtype).items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            want = plain()
            rel, err = compare(label, got, want, tol)
            log(f"  {label} {tag}: kernel vs plain max rel err {rel:.3e}, max abs err "
                f"{err:.3e}" + (f" (limit {tol:g}, flags equal)" if tol else ""))
            if name in BIT_EXACT:
                want_f = flat(want)
                differ = [k for k, g in flat(got).items() if not same_bits(g, want_f[k])]
                if differ:
                    raise AssertionError(f"{label} {tag}: {differ} differ from the plain "
                                         f"version (max abs err {err:.3e}); the kernel is "
                                         f"built to equal it to the bit")
                log(f"  {label} {tag}: equal to the plain version to the bit")
                if name == "rollout1":
                    check_k6_is_k3_first_trial(label, tag, kern, got)
            target = (report[name] if label in ROW_CASE else
                      report[name].setdefault("variants", {}).setdefault(label, {}))
            target[f"rel_err_{tag}"] = rel
            target["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            if tag == "f32":
                target["ms"] = cuda_ms(kern, 20)
                target["plain_ms"] = cuda_ms(plain, 2)
                # K6's plain version runs K3's two trials at one step
                # length and keeps the first: half its operations are K6's
                ops = count_ops(plain) // (2 if name == "rollout1" else 1)
                n_in, n_out, n_flags = io_values(name, T_PATH, ndx, nu, **io_kw)
                target["bound_ms"], target["bound_by"], nbytes = bound(
                    ops, n_in, n_out, n_flags, B_PATH, 4)
                target["ops"], target["bytes"] = ops, nbytes
                log(f"  {label} f32 time: kernel {target['ms']:.4f} ms, plain "
                    f"{target['plain_ms']:.4f} ms, bound {target['bound_ms']:.4f} ms "
                    f"({target['bound_by']}: {nbytes} bytes, {ops} ops)")
    # the kernels at four times the batch, kernel only; their operations
    # scale with B (elementwise per scenario)
    for label, (kern, _, io_kw, name, ndx, nu) in kernel_cases(torch.float32, B_FILL).items():
        if label not in FILL_CASE:
            continue
        ms = cuda_ms(kern, 10)
        ops = (report[name] if label in ROW_CASE else report[name]["variants"][label])["ops"]
        bms, by, _ = bound(ops * (B_FILL // B_PATH),
                           *io_values(name, T_PATH, ndx, nu, **io_kw), B_FILL, 4)
        report[name].setdefault("variants", {})[f"{label} B={B_FILL}"] = dict(
            ms=ms, bound_ms=bms, bound_by=by)
        log(f"  {label} f32 time at B={B_FILL}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by})")


@phase("n-DoF kernels")
def ndof_kernels_phase(report):
    """K1, K4, K3 and K6 at the 3- and 7-DoF SEA arms' instances, at the
    7-DoF path's shape (T=100, B_NDOF): to the bit against their plain
    versions in f64 and f32 (K6 also against K3's first trial), and in f32
    the kernel's time, the plain version's time (the call that was
    compared), its operations and the bound; then the kernel's time and
    bound at 4 B_NDOF, where K3 at nl 7, whose layout the batch picks, is
    held to the bit against its plain version again in f64 and f32. The
    7-DoF instances are their kernels' rows ``<name>_n7``, the 3-DoF ones
    variants of those rows."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import T_PATH

    def target(label, name):
        row = report[f"{name}_n7"]
        return row if "sea7" in label else row.setdefault("variants", {}).setdefault(label, {})

    # the 7-DoF instances of K6, K3, K4 and K1 (their own layouts; K3's by
    # the batch): each launch at B_NDOF and 4 B_NDOF, the blocks the card
    # keeps resident an SM, and the ptxas line of the instance (of K3's
    # layout at that batch)
    ptxas = kernel_ptxas(build.build_log, build.lib())
    for name, prefix in (("rollout1", "K6 {} nl 7 SEA gaps:"),
                         ("rollout2", "K3 {} nl 7 SEA gaps {}:"),
                         ("riccati_fddp", "K4 {} (ndx 28, nu 7,"),
                         ("linearize", "K1 {} nl 7 SEA either:")):
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            for B in (B_NDOF, 4 * B_NDOF):
                info = build.launch_of(name, dtype, B, T=T_PATH)
                layout = f", the {info['layout']} layout" if "layout" in info else ""
                log(f"  {name}_n7 {tag} B={B}: grid {info['grid']}, {info['threads']} threads a "
                    f"block, {info['smem']} bytes of dynamic shared memory, "
                    f"{info['blocks_per_sm']} blocks resident an SM{layout}")
                report[f"{name}_n7"].setdefault("launch", {})[f"{tag} B={B}"] = info
                line = [x for x in ptxas if x.startswith(prefix.format(tag, info.get("layout")))]
                if len(line) != 1:
                    raise AssertionError(f"{name}_n7 {tag}: no single ptxas line in {ptxas}")
                if B == B_NDOF or "layout" in info:
                    log(f"  {name}_n7 {tag} B={B} ptxas: {line[0]}")

    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases = kernel_cases(dtype, B_NDOF, ("sea3", "sea7"), T=T_PATH)
        for label, (kern, plain, io_kw, name, ndx, nu) in cases.items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            want, plain_ms = timed_once(plain)
            rel, err = compare(label, got, want, 1e-9 if tag == "f64" else None)
            want_f = flat(want)
            differ = [k for k, g in flat(got).items() if not same_bits(g, want_f[k])]
            if differ:
                raise AssertionError(f"{label} {tag}: {differ} differ from the plain version "
                                     f"(max abs err {err:.3e}); the kernel is built to equal it "
                                     f"to the bit")
            if name == "rollout1":
                check_k6_is_k3_first_trial(label, tag, kern, got)
            del got, want, want_f
            log(f"  {label} {tag} T={T_PATH} B={B_NDOF}: equal to the plain version to "
                f"the bit (max abs err {err:.3e})")
            t = target(label, name)
            t["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            if tag == "f64":
                continue
            t["ms"], t["plain_ms"] = cuda_ms(kern, 10), plain_ms
            # K6's plain version runs two trials and keeps one
            t["ops"] = count_ops(plain) // (2 if name == "rollout1" else 1)
            n_in, n_out, n_flags = io_values(name, T_PATH, ndx, nu, **io_kw)
            t["bound_ms"], t["bound_by"], nbytes = bound(t["ops"], n_in, n_out, n_flags,
                                                         B_NDOF, 4)
            t["bytes"] = nbytes
            log(f"  {label} f32 T={T_PATH} B={B_NDOF}: kernel {t['ms']:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                f"{nbytes} bytes, {t['ops']} ops)")
        del cases
    # the kernels at four times the batch, timed (kernel only; their
    # operations scale with B, elementwise per scenario); K3 at nl 7, whose
    # layout the batch picks, first held to the bit against its plain
    # version there, in f64 and f32
    B = 4 * B_NDOF
    k3 = "rollout2[sea7 gaps]"
    for label, (kern, plain, *_) in kernel_cases(torch.float64, B, ("sea7",), T=T_PATH).items():
        if label == k3:
            check_at_batch(label, "f64", kern, plain, B)
    for label, (kern, plain, io_kw, name, ndx, nu) in kernel_cases(
            torch.float32, B, ("sea3", "sea7"), T=T_PATH).items():
        t = report[f"{name}_n7"].setdefault("variants", {}).setdefault(f"{label} B={B}", {})
        if label == k3:
            t["max_abs_err_f32"] = check_at_batch(label, "f32", kern, plain, B)
        t["ms"] = cuda_ms(kern, 10)
        ops = target(label, name)["ops"] * (B // B_NDOF)
        t["bound_ms"], t["bound_by"], nbytes = bound(
            ops, *io_values(name, T_PATH, ndx, nu, **io_kw), B, 4)
        log(f"  {label} f32 T={T_PATH} B={B}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes} bytes, {ops} ops)")


def check_at_batch(label, tag, kern, plain, B):
    """The kernel's outputs equal to its plain version's to the bit at batch
    B (raises otherwise); returns the max abs error, 0."""
    from aslr_to_tpu_torch.measure import T_PATH

    got = kern()
    torch.cuda.synchronize()
    want = plain()
    _, err = compare(label, got, want, None)
    want_f = flat(want)
    differ = [k for k, g in flat(got).items() if not same_bits(g, want_f[k])]
    if differ:
        raise AssertionError(f"{label} {tag} B={B}: {differ} differ from the plain version "
                             f"(max abs err {err:.3e}); the kernel is built to equal it to the bit")
    log(f"  {label} {tag} T={T_PATH} B={B}: equal to the plain version to the bit (max abs err "
        f"{err:.3e})")
    return err


def timed_once(fn):
    """``fn()`` and the milliseconds of that one call, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same_bits(a, b):
    """Equal to the bit, NaN where the other has NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                             b.nan_to_num(0.0))


def check_k6_is_k3_first_trial(label, tag, kern, got):
    """K6 at alpha equals K3's first trial at alpha, to the bit (one
    trajectory code, rollout.cu::rollout_group)."""
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk

    a = kern.args                   # K6's inputs: (spec, xs, us, k, K, x0, alpha, ...)
    first, _ = vk.rollout2(*a[:7], 0.5 * a[6], *a[7:])
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, first):
        if not same_bits(g, w):
            raise AssertionError(f"{label} {tag}: K6's {field} differs from K3's first trial")
    log(f"  {label} {tag}: equal to K3's first trial to the bit")


@phase("probe")
def probe_phase(report):
    """P in every configuration against its plain version (raises on a
    difference), driven with the launch counters reset just before."""
    from aslr_to_tpu_torch import probe
    from aslr_to_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    rows = probe.run(log=log)
    row = report["probe"]
    row["launches"] = build.LAUNCHES["probe"]
    row.setdefault("launches_by_path", {})["probe"] = row["launches"]
    pick = next(r for r in rows if all(r[k] == v for k, v in PROBE_ROW.items()))
    row.update(case=PROBE_ROW, ms=pick["ms"], plain_ms=pick["plain_ms"],
               bound_ms=pick["bound_ms"], bound_by="operations",
               max_abs_err=max(r["max_abs_err"] for r in rows), configs=rows)


def drive(path, report, fn, expect):
    """Run ``fn`` with the launch counters reset just before and read just
    after; every kernel in ``expect`` must have launched. Returns the
    result and the seconds from the reset to the card's end."""
    from aslr_to_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"  launches in the {path} path: {launches}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")
    for row, kernel in ROW_KERNEL.items():
        # the row's instance or variant ran there
        if (row.endswith("_n7") == (path in NDOF_PATHS)
                and (row in TABLE_ROWS) == (path in PK_PATHS)):
            report[row].setdefault("launches_by_path", {})[path] = launches[kernel]
        if ROW_PATH[row] == path:
            report[row]["launches"] = launches[kernel]
    return out, seconds


def summarize(res, B, T, nu, label, tpu=None, nx=8):
    from aslr_to_tpu_torch.measure import summary

    assert res.xs.shape == (B, T + 1, nx) and res.us.shape == (B, T, nu)
    live = ~res.diverged
    if not bool(torch.isfinite(res.cost[live]).all()):
        raise AssertionError(f"{label}: non-finite cost in a lane that did not diverge")
    summ = summary(res)
    log(f"  convergence ({label}): converged_frac {summ['converged_frac']}, "
        f"diverged_frac {summ['diverged_frac']}, mean_iterations {summ['mean_iterations']}, "
        f"max_iterations {summ['max_iterations']}, median_cost {summ['median_cost']}, "
        f"lanes_by_iterations {summ['lanes_by_iterations']}")
    if tpu is not None:
        log(f"  for reference only, the TPU's f32 statistics on this config (BENCH_r05): {tpu}")
    return summ


def solve_path(name, report, card, expect, nu, n_timed, tpu=None, nx=8):
    """Drive the path ``name`` of measure.py at T=100 and its batch (4096,
    or 1024 for the 7-DoF paths), f32: its set-up (the SEA cold solve)
    where it has one, then ``n_timed`` solves. Returns the convergence
    summaries: the set-up's (or None) and the last solve's."""
    from aslr_to_tpu_torch.measure import build_path, path_batch, path_T

    p, B, T = build_path(name), path_batch(name), path_T(name)
    prep = setup_summ = None
    if name == "sea_warm":
        prep, t = drive("sea_cold", report, p.setup, expect)
        log(f"  cold solve: {t:.4f} s")
        setup_summ = summarize(prep, B, T, nu, "SEA cold, f32")
    elif name.endswith("mpc_tracking"):     # the first solve, untimed in the example
        prep, t = drive(name, report, p.setup, expect)
        log(f"  first solve: {t:.4f} s")
        setup_summ = summarize(prep, B, T, nu, f"{name}, first solve, f32")
    for i in range(n_timed):
        inputs = p.args(i, prep)
        res, t = drive(name, report, lambda: p.solve(*inputs), expect)
        log(f"  solve {i}: {t:.4f} s, {B / t:.2f} solves/s on {card} "
            f"(T={T}, B={B}, f32, maxiter={p.maxiter})")
    return setup_summ, summarize(res, B, T, nu, f"{name}, last solve, f32", tpu, nx)


@phase("main path")
def main_path_phase(report, card):
    return solve_path("boxddp", report, card, ("linearize", "riccati_box", "rollout2"), 4, 2,
                      TPU_REFERENCE["boxddp"])[1]


@phase("SEA warm")
def sea_warm_phase(report, card):
    return solve_path("sea_warm", report, card, ("linearize", "riccati_fddp", "rollout2"), 2,
                      2, TPU_REFERENCE["sea_warm"])[0]


@phase("BoxFDDP")
def boxfddp_phase(report, card):
    solve_path("boxfddp", report, card, ("linearize", "riccati_boxfddp", "rollout2"), 4, 1)


@phase("7-DoF")
def sevendof_phase(report, card):
    """The 7-DoF SEA reach through the lane route (K1, K4, K3 at nl = 7)
    and the fast route (K1, K4, K6), and the generic route in f64 against
    both at a small size."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, seven_dof_sea
    from aslr_to_tpu_torch.measure import x0_batch

    lanes = solve_path("sevendof", report, card, ("linearize", "riccati_fddp", "rollout2"), 7,
                       2, TPU_REFERENCE["sevendof"], nx=28)[1]
    fast = solve_path("fast_sevendof", report, card, ("linearize", "riccati_fddp", "rollout1"),
                      7, 1, nx=28)[1]
    close_to_lanes("fast 7-DoF", fast, lanes)
    w = seven_dof_sea(T=T_NDOF_GENERIC, dtype=torch.float64)
    settings = SolverSettings(maxiter=MAXITER_NDOF_GENERIC, th_stop=1e-5)
    x0s = x0_batch(B_NDOF_GENERIC, torch.float64, 3, nx=28)
    res = {}
    for route in (False, True, "lanes"):
        t0 = time.perf_counter()
        res[route] = make_batched_solver(w.problem, settings, use_gaps=True, bounds=None,
                                         warm_start=True, use_fast_path=route)(x0s)
        torch.cuda.synchronize()
        log(f"  7-DoF f64 T={T_NDOF_GENERIC} B={B_NDOF_GENERIC} maxiter={MAXITER_NDOF_GENERIC} "
            f"use_fast_path={route!r}: {time.perf_counter() - t0:.3f} s")
    lanes_equal("7-DoF lanes against generic", res["lanes"], res[False], B_NDOF_GENERIC, x0s)
    lanes_equal("7-DoF fast against generic", res[True], res[False], B_NDOF_GENERIC, x0s)
    return lanes


def close_to_lanes(label, fast, lanes):
    """The fast path's statistics within 3 points (1.5 mean iterations) of
    the lane path's on the same inputs."""
    gaps = {k: abs(fast[k] - lanes[k]) for k in ("converged_frac", "diverged_frac",
                                                  "mean_iterations")}
    log(f"  {label} against the lane path on the same inputs: {gaps}")
    if gaps["converged_frac"] > 0.03 or gaps["diverged_frac"] > 0.03 \
            or gaps["mean_iterations"] > 1.5:
        raise AssertionError(f"{label}: the fast path's statistics are far from the lane "
                             f"path's ({fast} against {lanes})")


@phase("fast path")
def fast_path_phase(report, card, lanes_boxddp, lanes_sea_cold):
    """The per-scenario solver's fused route (K1, Riccati, K6) on the main
    path's and the SEA cold solve's inputs."""
    summ = solve_path("fast_boxddp", report, card, ("linearize", "riccati_box", "rollout1"),
                      4, 2)[1]
    close_to_lanes("fast BoxDDP", summ, lanes_boxddp)
    summ = solve_path("fast_sea", report, card, ("linearize", "riccati_fddp", "rollout1"),
                      2, 1)[1]
    close_to_lanes("fast SEA FDDP (cold)", summ, lanes_sea_cold)


def first_parting(a, b, rtol=1e-8):
    """The first index where two per-iteration series part beyond rtol
    (NaN past a solve's last iteration on both), or None."""
    part = ((a - b).abs() > rtol * b.abs()) | (a.isnan() != b.isnan())
    idx = torch.nonzero(part).flatten()
    return int(idx[0]) if idx.numel() else None


def lanes_equal(label, a, b, B, x0s):
    """At least B - 1 lanes agree: equal iterations and flags, and cost
    within rtol 1e-8 unless the lane diverged in both (a diverged lane's
    cost is that of a blown-up rollout, chaotic in the last bit). Each lane
    that does not agree is printed with its x0 and the first iteration at
    which the two routes' per-iteration logs part; returns {lane: that
    iteration} for the lanes whose logs part."""
    parted = {}
    same = ((a.iterations == b.iterations) & (a.converged == b.converged)
            & (a.diverged == b.diverged))
    c_rel = (a.cost - b.cost).abs() / b.cost.abs()
    live = same & ~b.diverged
    agree = same & (b.diverged | (c_rel <= 1e-8))
    n_agree = int(agree.sum())
    worst = float(c_rel[live].max()) if bool(live.any()) else 0.0
    log(f"  {label}: {n_agree}/{B} lanes agree ({int(same.sum())} equal in iterations and "
        f"flags, {int((same & b.diverged).sum())} of them diverged in both); max cost rel err "
        f"in the lanes that did not diverge {worst:.3e}")
    for lane in torch.nonzero(~agree).flatten().tolist():
        log(f"    lane {lane}, x0 {x0s[lane].tolist()}: iterations {int(a.iterations[lane])} / "
            f"{int(b.iterations[lane])}, converged {bool(a.converged[lane])} / "
            f"{bool(b.converged[lane])}, diverged {bool(a.diverged[lane])} / "
            f"{bool(b.diverged[lane])}, cost {float(a.cost[lane])!r} / {float(b.cost[lane])!r}")
        logged = a.log.costs.shape[1] > 0 and b.log.costs.shape[1] > 0
        for field in ("stops", "costs", "steps", "regs") if logged else ():
            sa, sb = getattr(a.log, field)[lane], getattr(b.log, field)[lane]
            j = first_parting(sa, sb)
            if j is not None:
                parted[lane] = min(j, parted.get(lane, j))
                log(f"      {field} part first at iteration {j}: {float(sa[j])!r} / "
                    f"{float(sb[j])!r} (rel {float((sa[j] - sb[j]).abs() / sb[j].abs()):.3e})")
    if n_agree < B - 1:
        raise AssertionError(f"{label}: only {n_agree} of {B} lanes agree")
    return parted


def explain_parting(label, problem, settings, use_gaps, bounds, x0, j):
    """Re-run one lane through the generic and fast routes for the ``j``
    iterations before their logs part and print how far the iterates
    differ there, and each control that sits on a bound of the box in one
    route and not in the other (the BoxQP's clamped set is a discrete
    function of that: on the bound with the gradient pushing out)."""
    from aslr_to_tpu_torch import make_batched_solver

    short = dataclasses.replace(settings, maxiter=j)
    g, f = (make_batched_solver(problem, short, use_gaps=use_gaps, bounds=bounds,
                                use_fast_path=route)(x0) for route in (False, True))
    log(f"    {label}: after {j} iterations, xs rel diff "
        f"{float((g.xs - f.xs).abs().max() / g.xs.abs().max()):.3e}, us rel diff "
        f"{float((g.us - f.us).abs().max() / g.us.abs().max()):.3e}")
    if bounds is None:
        return
    on_g = (g.us[0] == bounds.lb) | (g.us[0] == bounds.ub)
    on_f = (f.us[0] == bounds.lb) | (f.us[0] == bounds.ub)
    for t, i in torch.nonzero(on_g != on_f).tolist():
        log(f"      knot {t}, control {i}: generic {float(g.us[0, t, i])!r}, fast "
            f"{float(f.us[0, t, i])!r} (box [{float(bounds.lb[i])}, {float(bounds.ub[i])}])")


def generic_check(label):
    """The generic solver (the reference) against the fast and lane routes
    in f64 on the card, T=40, B=64, maxiter=20: ``label`` "BoxDDP" or "SEA
    FDDP". BoxDDP runs in the tight box with cold QPs: the generic BoxQP
    stops iterating a converged QP (as the JAX package's does) and the
    kernels' runs all its iterations (as the Pallas kernel does), so
    2-iteration warm QPs part the two routes at 1e-6 within a few
    iterations, and in the preset's wide box a fifth of the lanes blow up in
    their first accepted rollout. A lane whose generic and fast logs part is
    re-run up to the parting (``explain_parting``)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import x0_batch

    settings = SolverSettings(maxiter=20, th_stop=1e-5)
    arm, use_gaps, seed = {"BoxDDP": ("vsa", False, 1), "SEA FDDP": ("sea", True, 3)}[label]
    w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T_GENERIC, dtype=torch.float64)
    bounds = tight_box(torch.float64) if arm == "vsa" else None
    x0s = x0_batch(B_GENERIC, torch.float64, seed)
    res = {}
    for route in (False, True, "lanes"):
        t0 = time.perf_counter()
        res[route] = make_batched_solver(w.problem, settings, use_gaps=use_gaps, bounds=bounds,
                                         keep_log=route != "lanes", use_fast_path=route)(x0s)
        torch.cuda.synchronize()
        log(f"  {label} f64 T={T_GENERIC} B={B_GENERIC} use_fast_path={route!r}: "
            f"{time.perf_counter() - t0:.3f} s")
    # (fast / generic, lanes / generic, fast / lanes)
    parted = lanes_equal(f"{label} fast against generic", res[True], res[False], B_GENERIC, x0s)
    for lane, j in parted.items():
        if j > 0:
            explain_parting(f"{label} lane {lane}", w.problem, settings, use_gaps, bounds,
                            x0s[lane:lane + 1], j)
    lanes_equal(f"{label} lanes against generic", res["lanes"], res[False], B_GENERIC, x0s)
    lanes_equal(f"{label} fast against lanes", res[True], res["lanes"], B_GENERIC, x0s)


@phase("generic timed")
def generic_timed_phase(card):
    """One timed f32 solve of the generic, fast and lane routes on the card,
    and the T=30 golden through SolverBoxDDP."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_PATH, summary, x0_batch
    from aslr_to_tpu_torch.solvers.ddp import SolverBoxDDP

    # the main path's settings but MAXITER_TIMED iterations: the generic
    # route runs thousands of small kernels a knot loop
    w = two_dof_vsa_boxddp(T=T_PATH, dtype=torch.float32)
    x0s = x0_batch(B_TIMED, torch.float32, 0)
    timed = SolverSettings(maxiter=MAXITER_TIMED, th_stop=1e-5, boxqp_warm_iters=2)
    for route in (False, True, "lanes"):
        solve = make_batched_solver(w.problem, timed, use_gaps=False, bounds=w.bounds,
                                    use_fast_path=route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(x0s)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        summ = summary(out)
        log(f"  BoxDDP f32 T={T_PATH} B={B_TIMED} maxiter={MAXITER_TIMED} "
            f"use_fast_path={route!r}: {t:.3f} s, {t / summ['max_iterations']:.4f} s a loop "
            f"pass, {B_TIMED / t:.2f} solves/s on {card}; converged {summ['converged_frac']}, "
            f"diverged {summ['diverged_frac']}, mean iterations {summ['mean_iterations']}")

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                               "vsa_boxddp_T30.npz"))
    w = two_dof_vsa_boxddp(T=30, dtype=torch.float64)
    solver = SolverBoxDDP(w.problem, w.bounds)
    solver.th_stop = 1e-7
    res = solver.solve(maxiter=25)
    cost, iters = float(res.cost), int(res.iterations)
    log(f"  SolverBoxDDP T=30 f64 on the card: cost {cost} (golden {float(ref['cost'])}), "
        f"iterations {iters} (golden {int(ref['iters'])})")
    if not (abs(cost - float(ref["cost"])) <= 1e-8 * abs(float(ref["cost"]))
            and iters == int(ref["iters"])):
        raise AssertionError("SolverBoxDDP does not reproduce vsa_boxddp_T30.npz on the card")


def parity(label, w, bounds, use_gaps, B, settings, seed):
    from aslr_to_tpu_torch import make_batched_solver
    from aslr_to_tpu_torch.measure import x0_batch

    x0s = x0_batch(B, torch.float64, seed)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(w.problem, settings, use_gaps=use_gaps, bounds=bounds,
                                    use_fast_path="lanes", backend=backend)
        t0 = time.perf_counter()
        res[backend] = solve(x0s)
        torch.cuda.synchronize()
        log(f"  {label} {backend} backend: {time.perf_counter() - t0:.3f} s")
    k, p = res["auto"], res["plain"]
    same = ((k.iterations == p.iterations) & (k.converged == p.converged)
            & (k.diverged == p.diverged))
    n_same = int(same.sum())
    for lane in torch.nonzero(~same).flatten().tolist():
        log(f"  {label} lane {lane} differs: kernel it={int(k.iterations[lane])} "
            f"conv={bool(k.converged[lane])} div={bool(k.diverged[lane])} "
            f"cost={float(k.cost[lane])}; plain it={int(p.iterations[lane])} "
            f"conv={bool(p.converged[lane])} div={bool(p.diverged[lane])} "
            f"cost={float(p.cost[lane])}")
    c_rel = ((k.cost - p.cost).abs() / p.cost.abs())[same]
    finite = torch.isfinite(c_rel)
    worst = float(c_rel[finite].max()) if bool(finite.any()) else 0.0
    log(f"  {label}: lanes equal in iterations and flags {n_same}/{B}; "
        f"max cost rel err in those lanes {worst:.3e}")
    if n_same < B - 1:
        raise AssertionError(f"{label}: only {n_same} of {B} lanes agree")
    if not worst <= 1e-8:
        raise AssertionError(f"{label}: cost rel err {worst:.3e} > 1e-8")


def parity_check(label):
    """A lane path in f64 through the kernels against its plain backend:
    BoxDDP and SEA FDDP at B=256, T=100, maxiter 20, BoxFDDP in a tight box
    at B=128, T=40, maxiter 10."""
    from aslr_to_tpu_torch import SolverSettings, two_dof_sea, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_PATH

    f64 = torch.float64
    if label == "BoxDDP":
        w = two_dof_vsa_boxddp(T=T_PATH, dtype=f64)
        parity(label, w, w.bounds, False, B_PARITY,
               SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2), seed=1)
    elif label == "SEA FDDP":
        parity(label, two_dof_sea(T=T_PATH, dtype=f64), None, True, B_PARITY,
               SolverSettings(maxiter=20, th_stop=1e-5), seed=3)
    else:
        parity(label, two_dof_vsa_boxddp(T=T_PARITY_BOX, dtype=f64), tight_box(f64), True,
               B_PARITY_BOX, SolverSettings(maxiter=10, th_stop=1e-7), seed=4)


# the checks that solve on the plain backend or the generic route, each a
# worker process's: those solves run thousands of small kernels a loop
# pass, so each waits on its host and leaves the card idle, and side by
# side they take the time of the longest. The tuples are the workers.
CHECKS = {"parity BoxDDP": partial(parity_check, "BoxDDP"),
          "parity SEA FDDP": partial(parity_check, "SEA FDDP"),
          "parity BoxFDDP": partial(parity_check, "BoxFDDP"),
          "generic BoxDDP": partial(generic_check, "BoxDDP"),
          "generic SEA FDDP": partial(generic_check, "SEA FDDP")}
CHECK_WORKERS = (("parity BoxDDP",), ("generic BoxDDP",), ("parity BoxFDDP",),
                 ("parity SEA FDDP", "generic SEA FDDP"))


def run_checks(names):
    """A worker: the checks ``names`` of CHECKS, in order, each printed as a
    phase; any failed check raises, so the worker exits non-zero."""
    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on a GPU only")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in names:
        phase(name)(CHECKS[name])()


def start_checks():
    """Start every worker of CHECK_WORKERS; each one's output is gathered
    by a thread of its own (a full pipe would stop the worker)."""
    pool = ThreadPoolExecutor(max_workers=len(CHECK_WORKERS))
    running = []
    for names in CHECK_WORKERS:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--check", *names],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((names, proc, pool.submit(proc.communicate)))
    pool.shutdown(wait=False)
    return running


def finish_checks(running):
    """Wait for every worker, print its output and raise if one failed."""
    failed = []
    for names, proc, out in running:
        text = out.result()[0]
        for line in text.splitlines():
            log(line)
        if proc.returncode != 0:
            failed.append(f"{', '.join(names)} (exit {proc.returncode})")
    if failed:
        raise AssertionError(f"failed checks: {'; '.join(failed)}")


def stop_checks(running):
    for _, proc, _ in running:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def golden(label, fname, w, settings, use_gaps, bounds, warm_start):
    from aslr_to_tpu_torch import make_batched_solver

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", fname))
    res = make_batched_solver(w.problem, settings, use_gaps=use_gaps, bounds=bounds,
                              warm_start=warm_start, use_fast_path="lanes")(
        torch.zeros(1, 8, dtype=torch.float64, device="cuda"))
    cost, iters = float(res.cost[0]), int(res.iterations[0])
    us_err = float(np.abs(res.us[0].cpu().numpy() - ref["us"]).max())
    log(f"  {label}: cost {cost} (golden {float(ref['cost'])}), iterations {iters} "
        f"(golden {int(ref['iters'])}), us max abs err {us_err:.3e}")
    if not (abs(cost - float(ref["cost"])) <= 1e-8 * abs(float(ref["cost"]))
            and iters == int(ref["iters"]) and us_err <= 1e-6):
        raise AssertionError(f"the {label} solve does not reproduce {fname}")


@phase("golden")
def golden_phase():
    from aslr_to_tpu_torch import SolverSettings, two_dof_sea, two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=30, dtype=torch.float64)
    golden("BoxDDP T=30", "vsa_boxddp_T30.npz", w, SolverSettings(maxiter=25, th_stop=1e-7),
           False, w.bounds, False)
    golden("SEA FDDP T=100, quasi-static warm", "sea_T100.npz",
           two_dof_sea(T=100, dtype=torch.float64), SolverSettings(maxiter=100, th_stop=1e-7),
           True, None, True)


def table_kernel_cases(dtype, B_target=None, B_box=None):
    """{label: (kernel call, plain call, io_values kwargs, name, ndx, nu, T,
    B, table bytes, row)} of the per-knot table variants at their paths'
    shapes: K1, K3 (gaps) and K6 (gaps) with the tracking MPC's target table
    on the SEA arm (T=60, B=2048), K2, K5, K3 and K6 with pk_boxddp's pinched
    box tables on the VSA arm (T=100, B=4096); and {label: (shared call,
    call with tables of equal rows)} on the same inputs."""
    from aslr_to_tpu_torch import stack_knots, two_dof_sea, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk
    from aslr_to_tpu_torch.measure import (B_MPC, B_PATH, T_MPC, T_PATH, mpc_problem,
                                           pinched_box, x0_batch)

    size = torch.empty(0, dtype=dtype).element_size()
    cases, equal_rows = {}, {}
    # the target table: the tracking MPC
    T, B = T_MPC, B_target or B_MPC
    problem = mpc_problem(T, dtype)
    spec = vk.extract_vsa_spec(problem, None)
    shared = vk.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype).problem, None)
    tgt = torch.as_tensor(spec.target_table(T, dtype), device="cuda")
    tgt_shared = torch.as_tensor(shared.target_table(T, dtype), device="cuda")
    x0 = x0_batch(B, dtype, seed=4).T.contiguous()
    xs = x0.expand(T + 1, 8, B).contiguous()
    us = problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
    lin = vk.linearize_plain(spec, xs, us, wterm, tgt)
    r = lin.run
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
              lin.term["Lx"], lin.term["Lxx"])
    fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
    reg = torch.full((B,), REG, dtype=dtype, device="cuda")
    bw = rk.riccati_fddp_plain(*derivs, fs, reg)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(B, dtype=dtype, device="cuda")
    infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
    tbytes = T * 12 * size
    la = (spec, xs, us, wterm, tgt)
    cases["linearize[sea target table]"] = (partial(vk.linearize, *la),
                                            partial(vk.linearize_plain, *la), dict(),
                                            "linearize", 8, 2, T, B, tbytes,
                                            "linearize:target_table")
    ra = (spec, xs, us, k, K, x0, ones, 0.5 * ones, wterm, None, None, fs, infeas, tgt)
    cases["rollout2[sea gaps target table]"] = (partial(vk.rollout2, *ra),
                                                partial(vk.rollout2_plain, *ra), dict(gaps=True),
                                                "rollout2", 8, 2, T, B, tbytes,
                                                "rollout2:target_table")
    r1 = ra[:6] + ra[7:]
    cases["rollout1[sea gaps target table]"] = (partial(vk.rollout1, *r1),
                                                partial(vk.rollout1_plain, *r1), dict(gaps=True),
                                                "rollout1", 8, 2, T, B, tbytes,
                                                "rollout1:target_table")
    la_s = (shared, xs, us, wterm)
    equal_rows["linearize[sea]"] = (partial(vk.linearize, *la_s),
                                    partial(vk.linearize, *la_s, tgt_shared))
    ra_s = (shared,) + ra[1:13]
    equal_rows["rollout2[sea gaps]"] = (partial(vk.rollout2, *ra_s),
                                        partial(vk.rollout2, *ra_s, tgt=tgt_shared))
    r1_s = ra_s[:6] + ra_s[7:]
    equal_rows["rollout1[sea gaps]"] = (partial(vk.rollout1, *r1_s),
                                        partial(vk.rollout1, *r1_s, tgt=tgt_shared))

    # the box tables: pk_boxddp's pinched box
    T, B = T_PATH, B_box or B_PATH
    w = two_dof_vsa_boxddp(T=T, dtype=dtype)
    problem = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * T),
                                  per_knot=True)
    box = pinched_box(T, dtype)
    spec = vk.extract_vsa_spec(problem, box)
    x0 = x0_batch(B, dtype, seed=5).T.contiguous()
    xs = x0.expand(T + 1, 8, B).contiguous()
    us = torch.zeros(T, 4, B, dtype=dtype, device="cuda")
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
    lin = vk.linearize_plain(spec, xs, us, wterm)
    r = lin.run
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
              lin.term["Lx"], lin.term["Lxx"])
    fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
    reg = torch.full((B,), REG, dtype=dtype, device="cuda")
    if dtype == torch.float64:
        reg[::512] = -5.0
    kprev = torch.zeros(T, 4, B, dtype=dtype, device="cuda")
    ones = torch.ones(B, dtype=dtype, device="cuda")
    bbytes = 2 * T * 4 * size
    kw = dict(per_knot_box=True)
    ba = derivs + (us, kprev, box.lb, box.ub, reg, 2)
    cases["riccati_box[vsa box table]"] = (partial(rk.riccati_box_backward, *ba, **kw),
                                           partial(rk.riccati_box_plain, *ba, **kw),
                                           dict(warm=True), "riccati_box", 8, 4, T, B, bbytes,
                                           "riccati_box:box_table")
    fa = derivs + (fs, us, kprev, box.lb, box.ub, reg, 2)
    cases["riccati_boxfddp[vsa box table]"] = (partial(rk.riccati_boxfddp_backward, *fa, **kw),
                                               partial(rk.riccati_boxfddp_plain, *fa, **kw),
                                               dict(warm=True), "riccati_boxfddp", 8, 4, T, B,
                                               bbytes, "riccati_boxfddp:box_table")
    bw = rk.riccati_box_plain(*ba, **kw)
    ra = (spec, xs, us, bw.k, bw.K, x0, ones, 0.5 * ones, wterm, box.lb, box.ub)
    cases["rollout2[vsa box table]"] = (partial(vk.rollout2, *ra),
                                        partial(vk.rollout2_plain, *ra), dict(), "rollout2",
                                        8, 4, T, B, bbytes, "rollout2:box_table")
    r1 = ra[:6] + ra[7:]
    cases["rollout1[vsa box table]"] = (partial(vk.rollout1, *r1),
                                        partial(vk.rollout1_plain, *r1), dict(), "rollout1",
                                        8, 4, T, B, bbytes, "rollout1:box_table")
    # tables whose rows are all the shared box, against the box a lane
    lanes = [b[:, None].expand(4, B).contiguous() for b in tight_box(dtype)]
    rows = [b[None].expand(T, 4).contiguous() for b in tight_box(dtype)]
    tabled = spec._replace(lb=rows[0].double().cpu().numpy(), ub=rows[1].double().cpu().numpy())
    plain_spec = vk.extract_vsa_spec(w.problem, tight_box(dtype))
    equal_rows["riccati_box[vsa]"] = (
        partial(rk.riccati_box_backward, *derivs, us, kprev, *lanes, reg, 2),
        partial(rk.riccati_box_backward, *derivs, us, kprev, *rows, reg, 2, **kw))
    equal_rows["riccati_boxfddp[vsa]"] = (
        partial(rk.riccati_boxfddp_backward, *derivs, fs, us, kprev, *lanes, reg, 2),
        partial(rk.riccati_boxfddp_backward, *derivs, fs, us, kprev, *rows, reg, 2, **kw))
    for name in ("rollout2", "rollout1"):
        pre = (xs, us, bw.k, bw.K, x0, ones) + ((0.5 * ones,) if name == "rollout2" else ())
        fn = getattr(vk, name)
        equal_rows[f"{name}[vsa box]"] = (partial(fn, plain_spec, *pre, wterm, *lanes),
                                          partial(fn, tabled, *pre, wterm, *rows))
    return cases, equal_rows


@phase("per-knot kernels")
def table_kernels_phase(report):
    """The per-knot table variants against their plain versions to the bit
    in f64 and f32 at their paths' shapes, timed in f32 (kernel, plain
    version on the compared call, bound with the tables' bytes) there and
    at B=16384; tables of equal rows against the shared route, to the bit,
    in both types."""
    from aslr_to_tpu_torch.kernels import build

    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases, equal_rows = table_kernel_cases(dtype)
        for label, (kern, plain, io_kw, name, ndx, nu, T, B, tbytes, row) in cases.items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            want, plain_ms = timed_once(plain)
            rel, err = compare(label, got, want, 1e-9 if tag == "f64" else None)
            want_f = flat(want)
            differ = [k for k, g in flat(got).items() if not same_bits(g, want_f[k])]
            if differ:
                raise AssertionError(f"{label} {tag}: {differ} differ from the plain version "
                                     f"(max abs err {err:.3e}); the kernel is built to equal it "
                                     f"to the bit")
            if name == "rollout1":
                check_k6_is_k3_first_trial(label, tag, kern, got)
            del got, want, want_f
            log(f"  {label} {tag} T={T} B={B}: equal to the plain version to the bit "
                f"(max abs err {err:.3e})")
            t = report[row]
            t["case"], t["T"], t["B"] = label, T, B
            t["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            if tag == "f64":
                continue
            # the device time of a launch: at the MPC's shapes a launch is
            # shorter than the wrapper's host time, which CUDA events count
            t["ms"], t["events_ms"] = device_ms(kern, 10, f"{name}_kernel"), cuda_ms(kern, 10)
            t["plain_ms"] = plain_ms
            t["ops"] = count_ops(plain) // (2 if name == "rollout1" else 1)
            t["bound_ms"], t["bound_by"], t["bytes"] = bound(
                t["ops"], *io_values(name, T, ndx, nu, **io_kw), B, 4, tbytes)
            log(f"  {label} f32 T={T} B={B}: kernel {t['ms']:.4f} ms (device; CUDA events "
                f"{t['events_ms']:.4f} ms), plain {plain_ms:.4f} ms, bound {t['bound_ms']:.4f} "
                f"ms ({t['bound_by']}: {t['bytes']} bytes, {t['ops']} ops)")
        for label, (shared, tabled) in equal_rows.items():
            a, b = shared(), tabled()
            torch.cuda.synchronize()
            bf = flat(b)
            differ = [k for k, g in flat(a).items() if not same_bits(g, bf[k])]
            if differ:
                raise AssertionError(f"{label} {tag}: tables of equal rows differ from the "
                                     f"shared route in {differ}")
            log(f"  {label} {tag}: tables of equal rows give the shared route's bits")
            if tag == "f32":    # the tables' own cost, on the same data (device time)
                row = EQUAL_ROWS_ROW[label]
                kernel = f"{ROW_KERNEL[row]}_kernel"
                report[row]["equal_rows"] = dict(shared_ms=device_ms(shared, 10, kernel),
                                                  table_ms=device_ms(tabled, 10, kernel))
                log(f"  {label} f32: shared {report[row]['equal_rows']['shared_ms']:.4f} ms, "
                    f"tables of equal rows {report[row]['equal_rows']['table_ms']:.4f} ms "
                    f"(device)")
        del cases, equal_rows
    cases, _ = table_kernel_cases(torch.float32, B_FILL, B_FILL)
    for label, (kern, _, io_kw, name, ndx, nu, T, _, tbytes, row) in cases.items():
        t = report[row]
        ms = device_ms(kern, 10, f"{name}_kernel")
        ops = t["ops"] * B_FILL // t["B"]
        bms, by, _ = bound(ops, *io_values(name, T, ndx, nu, **io_kw), B_FILL, 4, tbytes)
        t.setdefault("variants", {})[f"{label} B={B_FILL}"] = dict(ms=ms, bound_ms=bms,
                                                                   bound_by=by)
        log(f"  {label} f32 T={T} B={B_FILL}: kernel {ms:.4f} ms (device), bound {bms:.4f} ms "
            f"({by})")


def pk_parity(label, report, path, problem, bounds, use_gaps, route, T, expect, settings):
    """One f64 solve of a per-knot route through the kernels (driven with
    the launch counters reset, as ``path``) against its plain backend, B=64:
    at least B-1 lanes equal in iterations and flags with cost within rtol
    1e-8."""
    from aslr_to_tpu_torch import make_batched_solver
    from aslr_to_tpu_torch.measure import x0_batch

    x0s = x0_batch(B_PK_PARITY, torch.float64, 6)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(problem, settings, use_gaps=use_gaps, bounds=bounds,
                                    use_fast_path=route, backend=backend)
        if backend == "auto":
            res[backend], t = drive(path, report, lambda: solve(x0s), expect)
        else:
            t0 = time.perf_counter()
            res[backend] = solve(x0s)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        log(f"  {label} f64 T={T} B={B_PK_PARITY} {backend} backend: {t:.3f} s")
    lanes_equal(f"{label}: kernels against the plain backend", res["auto"], res["plain"],
                B_PK_PARITY, x0s)


@phase("per-knot")
def per_knot_phase(report, card):
    """The per-knot paths (measure.py: mpc_tracking, fast_mpc_tracking,
    pk_boxddp) on the card, f32: solves/s and the convergence accounting,
    the fast route within 3 points of the lane route, the TPU's converged
    share beside the MPC's, and the pinched knots clamped."""
    from aslr_to_tpu_torch.measure import MPC_SOLVES, PINCH, PINCHED, build_path, path_T

    lanes = solve_path("mpc_tracking", report, card, ("linearize", "riccati_fddp", "rollout2"),
                       2, MPC_SOLVES)[1]
    fast = solve_path("fast_mpc_tracking", report, card,
                      ("linearize", "riccati_fddp", "rollout1"), 2, MPC_SOLVES)[1]
    close_to_lanes("fast MPC tracking", fast, lanes)
    gap = TPU_MPC_CONVERGED - lanes["converged_frac"]
    log(f"  MPC tracking converged {lanes['converged_frac']} against the TPU's "
        f"{TPU_MPC_CONVERGED} (docs/BENCH.md:449-451, a cross-check only): "
        f"{100 * gap:.2f} points {'within' if abs(gap) <= 0.05 else 'beyond'} 5")

    p, T = build_path("pk_boxddp"), path_T("pk_boxddp")
    res, t = drive("pk_boxddp", report, lambda: p.solve(*p.args(0, None)),
                   ("linearize", "riccati_box", "rollout2"))
    B = res.us.shape[0]
    log(f"  pk_boxddp solve: {t:.4f} s, {B / t:.2f} solves/s on {card} (T={T}, B={B}, f32, "
        f"maxiter={p.maxiter})")
    summarize(res, B, T, 4, "pk_boxddp, f32")
    knots = list(PINCHED)
    on = (res.us[:, knots, :2].abs() == PINCH)
    log(f"  pinched knots {knots[0]}-{knots[-1]}: {int(on.any(-1).any(-1).sum())} of {B} lanes "
        f"have a torque exactly on +-{PINCH} ({int(on.sum())} controls)")
    if not bool(on.any()):
        raise AssertionError("pk_boxddp: no control sits on the pinched knots' box")


@phase("per-knot checks")
def per_knot_checks_phase(report):
    """f64 parity of each per-knot route against its plain backend
    (B=64), and the generic route against the lane route (T=20, B=16)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, stack_knots
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_MPC, mpc_problem, pinched_box, x0_batch

    f64 = torch.float64
    pk_settings = SolverSettings(maxiter=MAXITER_PK_PARITY, th_stop=1e-5, boxqp_warm_iters=2)
    pk_parity("MPC tracking (lanes)", report, "pk_parity_mpc", mpc_problem(T_MPC, f64), None,
              True, "lanes", T_MPC, ("linearize", "riccati_fddp", "rollout2"),
              SolverSettings(maxiter=MAXITER_PK_PARITY, th_stop=1e-5))
    Tb = T_PK_PARITY_BOX
    w = two_dof_vsa_boxddp(T=Tb, dtype=f64)
    stacked = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * Tb),
                                  per_knot=True)
    box = pinched_box(Tb, f64, knots=range(Tb // 2 - 5, Tb // 2 + 5))
    pk_parity("pinched BoxDDP (lanes)", report, "pk_parity_boxddp", stacked, box, False, "lanes",
              Tb, ("linearize", "riccati_box", "rollout2"), pk_settings)
    pk_parity("pinched BoxFDDP (lanes)", report, "pk_parity_boxfddp", stacked, box, True,
              "lanes", Tb, ("linearize", "riccati_boxfddp", "rollout2"), pk_settings)
    pk_parity("pinched BoxDDP (fast)", report, "pk_parity_fast_boxddp", stacked, box, False,
              True, Tb, ("linearize", "rollout1"), pk_settings)

    # the generic route (the reference) against the lane route
    Tg, Bg = T_PK_GENERIC, B_PK_GENERIC
    gs = SolverSettings(maxiter=MAXITER_PK_GENERIC, th_stop=1e-5)
    w = two_dof_vsa_boxddp(T=Tg, dtype=f64)
    stacked = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * Tg),
                                  per_knot=True)
    for label, problem, bounds, use_gaps in (
            ("MPC tracking", mpc_problem(Tg, f64), None, True),
            ("pinched BoxDDP", stacked, pinched_box(Tg, f64, knots=range(Tg // 2 - 2, Tg // 2 + 2)),
             False)):
        x0s = x0_batch(Bg, f64, 7)
        res = {}
        for route in (False, "lanes"):
            t0 = time.perf_counter()
            res[route] = make_batched_solver(problem, gs, use_gaps=use_gaps, bounds=bounds,
                                             use_fast_path=route)(x0s)
            torch.cuda.synchronize()
            log(f"  {label} f64 T={Tg} B={Bg} maxiter={MAXITER_PK_GENERIC} "
                f"use_fast_path={route!r}: {time.perf_counter() - t0:.3f} s")
        lanes_equal(f"{label} lanes against generic", res["lanes"], res[False], Bg, x0s)


def main():
    card, smi = device_phase()
    build_phase()
    report = {name: dict(name=name, route="cuda", **meta, library_ms=None,
                         library_note=NO_LIBRARY) for name, meta in KERNELS.items()}
    kernels_phase(report)
    probe_phase(report)
    ndof_kernels_phase(report)
    lanes_boxddp = main_path_phase(report, smi)
    lanes_sea_cold = sea_warm_phase(report, smi)
    boxfddp_phase(report, smi)
    sevendof_phase(report, smi)
    fast_path_phase(report, smi, lanes_boxddp, lanes_sea_cold)
    table_kernels_phase(report)
    per_knot_phase(report, smi)
    generic_timed_phase(smi)
    # the checks below time nothing: the workers run beside this process
    running = start_checks()
    try:
        per_knot_checks_phase(report)
        golden_phase()
        finish_checks(running)
    finally:
        stop_checks(running)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for row in report.values():
        missing = [k for k in keys if k not in row]
        if missing:
            raise AssertionError(f"kernel row {row['name']} lacks {missing}")
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        run_checks(sys.argv[2:])
    else:
        main()
