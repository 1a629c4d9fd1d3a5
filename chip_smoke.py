"""Drive the PyTorch port's solver paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and time:
  1. device: a CUDA card must be present (else exit 2); its name and power
     limit as nvidia-smi reports them;
  2. build: one nvcc per aslr_to_tpu_torch/csrc/*.cu for sm_90a, all at
     once (-Xptxas -v), then the link; the box kernel's and each rollout
     instantiation's dynamic shared memory, and the rollouts' registers and
     spills;
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes (T=100, B=4096): float64 to a relative error of 1e-9
     with equal flags, float32 reported; K3 and K6 to the bit in both, and
     K6 equal to K3's first trial at the same step length; kernel and plain
     times from CUDA events after a warm-up; the least time the card could
     take for the same work (bytes over 3.35 TB/s against arithmetic
     operations over 67 TFLOP/s f32). K1 runs its VSA and SEA variants, K3
     and K6 their box, unbounded and SEA-gap variants, K4 the SEA shape with
     gaps, K5 the VSA shape; K2, K5 (one box kernel), K3 and K6 (one
     rollout kernel) also time f32 at B=16384, kernel only, to show whether
     they fill the card;
     probe: P (aslr_to_tpu_torch/probe.py) in each configuration (ilp 1,
     2, 4, 8; B 65536, 1048576; mul+add and fma) against its plain
     version, with its time, GFLOP/s and bound;
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
     lane: BoxDDP (B=256, T=100), SEA FDDP (B=256, T=100), BoxFDDP in a
     tight box (B=128, T=40);
  8. golden: the T=30 BoxDDP solve against tests/golden/vsa_boxddp_T30.npz
     and the quasi-static-warm T=100 SEA FDDP solve against
     tests/golden/sea_T100.npz, both float64 through the kernels;
  9. fast path: the per-scenario solver's fused route,
     make_batched_solver(..., use_fast_path=True) (K1, the Riccati kernel,
     K6 one trial a line-search round), on the BoxDDP main path's inputs
     and on the SEA cold solve's (measure.py paths fast_boxddp, fast_sea),
     T=100, B=4096, f32; its convergence statistics must land within 3
     points (1.5 mean iterations) of the lane path's on the same inputs;
 10. generic: the generic solver (use_fast_path=False, the reference),
     the fast path and the lane path in float64 at T=40, B=64, maxiter=20
     (BoxDDP in the tight box with cold QPs, SEA FDDP), at least B-1 lanes
     equal in iterations and flags with cost within rtol 1e-8 (a lane
     diverged in both excepted) pairwise, a lane whose generic and fast
     logs part re-run to the parting with the controls that sit on a
     bound in one route only printed; one timed f32 solve of each
     route at T=100, B=256 with the main path's settings and maxiter=2
     (BoxDDP); the T=30 BoxDDP golden through SolverBoxDDP.

Any failed check raises, so the script exits non-zero. The line before the
card's line is the kernel table as JSON; the last line is the device
record.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# the TPU's f32 statistics (the JAX package's benchmark record
# BENCH_r05.json), printed beside the card's for reference only
TPU_REFERENCE = dict(boxddp=dict(converged_frac=0.0, diverged_frac=0.211, mean_iterations=18.4),
                     sea_warm=dict(converged_frac=0.9998))
KERNELS = {
    "linearize": dict(source="aslr_to_tpu_torch/csrc/linearize.cu",
                      replaces="aslr_to_tpu/pallas/vsa_kernels.py:797"),
    "riccati_box": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                        replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "rollout2": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                     replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "riccati_fddp": dict(source="aslr_to_tpu_torch/csrc/riccati_fddp.cu",
                         replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "riccati_boxfddp": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                            replaces="aslr_to_tpu/pallas/riccati.py:294"),
    "rollout1": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                     replaces="aslr_to_tpu/pallas/vsa_kernels.py:430"),
    "probe": dict(source="aslr_to_tpu_torch/csrc/probe.cu",
                  replaces="scripts/probe_sublane.py:40"),
}
# the case each kernel's row is timed on, and the path its launches come
# from; the other cases of a kernel are reported as its variants
ROW_CASE = ("linearize[vsa]", "riccati_box[vsa]", "rollout2[vsa box]", "riccati_fddp[sea]",
            "riccati_boxfddp[vsa]", "rollout1[vsa box]")
# P is on no solver path: its launches are those of the probe phase
ROW_PATH = {"linearize": "boxddp", "riccati_box": "boxddp", "rollout2": "boxddp",
            "riccati_fddp": "sea_warm", "riccati_boxfddp": "boxfddp",
            "rollout1": "fast_boxddp", "probe": "probe"}
PROBE_ROW = dict(B=1048576, ilp=1, mode="mul_add")
NO_LIBRARY = ("no single PyTorch call computes this function (a serial per-scenario "
              "recursion); no stand-in timed")
# BoxDDP and SEA FDDP parity at the main path's depth (measure.T_PATH)
B_PARITY, B_PARITY_BOX, T_PARITY_BOX = 256, 128, 40
T_GENERIC, B_GENERIC, B_TIMED, MAXITER_TIMED = 40, 64, 256, 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
REG = 1e-9
B_FILL = 16384                     # the box kernel's and the rollouts' batch-filling variant


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


def bound(ops, n_in, n_out, n_flags, B, itemsize):
    """(bound_ms, bound_by, bytes): the least time for the work."""
    nbytes = (n_in + n_out) * B * itemsize + n_flags * B
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
    log(f"built {path.name} in {time.perf_counter() - t0:.3f} s")
    for line in build.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "== ")):
            log(f"  ptxas: {line.strip()}")
    smem = build.lib().aslr_riccati_box_smem
    for label, nu, gaps in (("K2", 4, 0), ("K5", 4, 1), ("K5", 2, 1)):
        log(f"  box kernel {label} (ndx 8, nu {nu}): dynamic shared memory a block of 128 "
            f"threads, f32 {smem(nu, gaps, 4)} bytes, f64 {smem(nu, gaps, 8)} bytes")
    for line in rollout_ptxas(build.build_log, build.lib().aslr_rollout_smem):
        log(f"  rollout {line}")


def rollout_ptxas(build_log, smem):
    """One line per instantiation of the rollouts (K3 and K6): registers,
    stack frame and spills from ptxas, and the block's dynamic shared
    memory."""
    entry = re.compile(r"Compiling entry function '\w*rollout([12])_kernelI([fd])Li2ELb([01])"
                       r"ELb([01])ELb([01])E")
    lines, name, frame = [], None, ""
    for line in build_log.splitlines():
        m = entry.search(line)
        if m:
            nt, s, sea, boxed, gaps = m.groups()
            name = (f"{'K3' if nt == '2' else 'K6'} {'f32' if s == 'f' else 'f64'} "
                    f"{'SEA' if sea == '1' else 'VSA'}{' box' if boxed == '1' else ''}"
                    f"{' gaps' if gaps == '1' else ''}",
                    smem(int(nt), int(sea), int(gaps), 4 if s == "f" else 8))
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


def kernel_cases(dtype, B=None, arms=("vsa", "sea")):
    """{row: (kernel call, plain call, io_values kwargs, name, ndx, nu)} at
    the paths' shapes (T=100, B=4096 unless given)."""
    from aslr_to_tpu_torch import two_dof_sea, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk
    from aslr_to_tpu_torch.measure import B_PATH
    from aslr_to_tpu_torch.measure import T_PATH as T
    from aslr_to_tpu_torch.measure import x0_batch

    B = B or B_PATH
    cases = {}
    for arm in arms:
        w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        nu = spec.nu
        x0 = x0_batch(B, dtype, seed=0).T.contiguous()
        xs = x0.expand(T + 1, 8, B).contiguous()
        if arm == "sea":        # the warm start's quasi-static controls
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
                                      dict(), "linearize", 8, nu)
        if arm == "vsa":
            lb = torch.as_tensor(spec.lb, dtype=dtype, device="cuda")[:, None].expand(nu, B)
            ub = torch.as_tensor(spec.ub, dtype=dtype, device="cuda")[:, None].expand(nu, B)
            lb, ub = lb.contiguous(), ub.contiguous()
            kprev = torch.zeros(T, nu, B, dtype=dtype, device="cuda")
            box_args = derivs + (us, kprev, lb, ub, reg, 2)
            cases["riccati_box[vsa]"] = (lambda a=box_args: rk.riccati_box_backward(*a),
                                         lambda a=box_args: rk.riccati_box_plain(*a),
                                         dict(warm=True), "riccati_box", 8, nu)
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
            cases["riccati_fddp[sea]"] = (lambda a=fd_args: rk.riccati_fddp_backward(*a),
                                          lambda a=fd_args: rk.riccati_fddp_plain(*a),
                                          dict(), "riccati_fddp", 8, nu)
            bw = rk.riccati_fddp_plain(*fd_args)
            k = torch.where(bw.ok, bw.k, 0.0)
            K = torch.where(bw.ok, bw.K, 0.0)
            # feasible and infeasible lanes: a feasible lane contracts nothing
            infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
            roll_args = (spec, xs, us, k, K, x0, ones, 0.5 * ones, wterm, None, None,
                         fs, infeas)
            cases["rollout2[sea gaps]"] = (lambda a=roll_args: vk.rollout2(*a),
                                           lambda a=roll_args: vk.rollout2_plain(*a),
                                           dict(gaps=True), "rollout2", 8, nu)
            r1 = roll_args[:6] + roll_args[7:]
            cases["rollout1[sea gaps]"] = (partial(vk.rollout1, *r1),
                                           partial(vk.rollout1_plain, *r1),
                                           dict(gaps=True), "rollout1", 8, nu)
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
            rel, err = compare(label, got, plain(), tol)
            log(f"  {label} {tag}: kernel vs plain max rel err {rel:.3e}, max abs err "
                f"{err:.3e}" + (f" (limit {tol:g}, flags equal)" if tol else ""))
            if name in ("rollout2", "rollout1"):
                if err != 0.0:
                    raise AssertionError(f"{label} {tag}: the rollout differs from its plain "
                                         f"version by {err:.3e}; it is built to equal it to "
                                         f"the bit")
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
    # the box kernel and the rollouts at four times the batch, kernel only;
    # their operations scale with B (elementwise per scenario)
    for label, (kern, _, io_kw, name, ndx, nu) in kernel_cases(torch.float32, B_FILL,
                                                               ("vsa",)).items():
        if label not in ROW_CASE or name == "linearize":
            continue
        ms = cuda_ms(kern, 10)
        bms, by, _ = bound(report[name]["ops"] * (B_FILL // B_PATH),
                           *io_values(name, T_PATH, ndx, nu, **io_kw), B_FILL, 4)
        report[name].setdefault("variants", {})[f"{label} B={B_FILL}"] = dict(
            ms=ms, bound_ms=bms, bound_by=by)
        log(f"  {label} f32 time at B={B_FILL}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by})")


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
    for name, n in launches.items():
        report[name].setdefault("launches_by_path", {})[path] = n
        if ROW_PATH[name] == path:
            report[name]["launches"] = n
    return out, seconds


def summarize(res, B, T, nu, label, tpu=None):
    from aslr_to_tpu_torch.measure import summary

    assert res.xs.shape == (B, T + 1, 8) and res.us.shape == (B, T, nu)
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


def solve_path(name, report, card, expect, nu, n_timed, tpu=None):
    """Drive the path ``name`` of measure.py at T=100, B=4096, f32: its
    set-up (the SEA cold solve) where it has one, then ``n_timed`` solves.
    Returns the convergence summaries: the set-up's (or None) and the last
    solve's."""
    from aslr_to_tpu_torch.measure import B_PATH, T_PATH, build_path

    p = build_path(name)
    prep = setup_summ = None
    if name == "sea_warm":
        prep, t = drive("sea_cold", report, p.setup, expect)
        log(f"  cold solve: {t:.4f} s")
        setup_summ = summarize(prep, B_PATH, T_PATH, nu, "SEA cold, f32")
    for i in range(n_timed):
        inputs = p.args(i, prep)
        res, t = drive(name, report, lambda: p.solve(*inputs), expect)
        log(f"  solve {i}: {t:.4f} s, {B_PATH / t:.2f} solves/s on {card} "
            f"(T={T_PATH}, B={B_PATH}, f32, maxiter={p.maxiter})")
    return setup_summ, summarize(res, B_PATH, T_PATH, nu, f"{name}, last solve, f32", tpu)


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


@phase("generic")
def generic_phase(card):
    """The generic solver (the reference) against the fast and lane
    routes in f64, one timed f32 solve of each route, and the T=30 golden
    through SolverBoxDDP, all on the card. BoxDDP runs in the tight box
    with cold QPs: the generic BoxQP stops iterating a converged QP (as the
    JAX package's does) and the kernels' runs all its iterations (as the
    Pallas kernel does), so 2-iteration warm QPs part the two routes at
    1e-6 within a few iterations, and in the preset's wide box a fifth of
    the lanes blow up in their first accepted rollout. A lane whose
    generic and fast logs part is re-run up to the parting
    (``explain_parting``)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_PATH, summary, x0_batch
    from aslr_to_tpu_torch.solvers.ddp import SolverBoxDDP

    settings = SolverSettings(maxiter=20, th_stop=1e-5)
    for label, arm, use_gaps, seed in (("BoxDDP", "vsa", False, 1), ("SEA FDDP", "sea", True, 3)):
        w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T_GENERIC,
                                                                  dtype=torch.float64)
        bounds = tight_box(torch.float64) if arm == "vsa" else None
        x0s = x0_batch(B_GENERIC, torch.float64, seed)
        res = {}
        for route in (False, True, "lanes"):
            t0 = time.perf_counter()
            res[route] = make_batched_solver(w.problem, settings, use_gaps=use_gaps,
                                             bounds=bounds, keep_log=route != "lanes",
                                             use_fast_path=route)(x0s)
            torch.cuda.synchronize()
            log(f"  {label} f64 T={T_GENERIC} B={B_GENERIC} use_fast_path={route!r}: "
                f"{time.perf_counter() - t0:.3f} s")
        # (fast / generic, lanes / generic, fast / lanes)
        parted = lanes_equal(f"{label} fast against generic", res[True], res[False],
                             B_GENERIC, x0s)
        for lane, j in parted.items():
            if j > 0:
                explain_parting(f"{label} lane {lane}", w.problem, settings, use_gaps, bounds,
                                x0s[lane:lane + 1], j)
        lanes_equal(f"{label} lanes against generic", res["lanes"], res[False], B_GENERIC,
                    x0s)
        lanes_equal(f"{label} fast against lanes", res[True], res["lanes"], B_GENERIC, x0s)

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


@phase("parity")
def parity_phase():
    from aslr_to_tpu_torch import SolverSettings, two_dof_sea, two_dof_vsa_boxddp

    from aslr_to_tpu_torch.measure import T_PATH

    f64 = torch.float64
    w = two_dof_vsa_boxddp(T=T_PATH, dtype=f64)
    parity("BoxDDP", w, w.bounds, False, B_PARITY,
           SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2), seed=1)
    parity("SEA FDDP", two_dof_sea(T=T_PATH, dtype=f64), None, True, B_PARITY,
           SolverSettings(maxiter=20, th_stop=1e-5), seed=3)
    parity("BoxFDDP", two_dof_vsa_boxddp(T=T_PARITY_BOX, dtype=f64), tight_box(f64), True,
           B_PARITY_BOX, SolverSettings(maxiter=10, th_stop=1e-7), seed=4)


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


def main():
    card, smi = device_phase()
    build_phase()
    report = {name: dict(name=name, route="cuda", **meta, library_ms=None,
                         library_note=NO_LIBRARY) for name, meta in KERNELS.items()}
    kernels_phase(report)
    probe_phase(report)
    lanes_boxddp = main_path_phase(report, smi)
    lanes_sea_cold = sea_warm_phase(report, smi)
    boxfddp_phase(report, smi)
    fast_path_phase(report, smi, lanes_boxddp, lanes_sea_cold)
    parity_phase()
    golden_phase()
    generic_phase(smi)
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
    main()
