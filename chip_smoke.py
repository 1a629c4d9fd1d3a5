"""Drive the PyTorch port's BoxDDP main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and time:
  1. device: a CUDA card must be present (else exit 2); its name and power
     limit as nvidia-smi reports them;
  2. build: nvcc compiles aslr_to_tpu_torch/csrc/*.cu for sm_90a (-Xptxas -v);
  3. kernels: each of the three kernels against its plain PyTorch version on
     the card, at the main path's shapes (two_dof_vsa_boxddp, T=100,
     B=4096): float64 to a relative error of 1e-9 with equal flags, float32
     reported; kernel and plain times from CUDA events after a warm-up;
  4. main path: make_batched_solver(..., use_fast_path="lanes") on T=100,
     B=4096, float32, with the launch counters reset before and read after;
     convergence summary and solves/s;
  5. parity: the same solve at B=256 in float64, kernel backend against the
     plain backend, lane by lane;
  6. golden: the single-scenario T=30 solve against tests/golden/vsa_boxddp_T30.npz.

Any failed check raises, so the script exits non-zero. The line before the
last is the kernel table as JSON; the last line is the device record.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the TPU's f32 statistics on this configuration (the JAX package's
# benchmark record BENCH_r05.json), printed beside the card's for reference
TPU_REFERENCE = dict(converged_frac=0.0, diverged_frac=0.211, mean_iterations=18.4)
KERNELS = {
    "linearize": dict(source="aslr_to_tpu_torch/csrc/linearize.cu",
                      replaces="aslr_to_tpu/pallas/vsa_kernels.py:797"),
    "riccati_box": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                        replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "rollout2": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                     replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
}
T_MAIN, B_MAIN, B_PARITY = 100, 4096, 256


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
    # plain versions use no matmul, but state the precision anyway
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
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            log(f"  ptxas: {line.strip()}")


def main_inputs(dtype, B, T, seed=0):
    from aslr_to_tpu_torch import two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x0s = 0.05 * torch.randn(B, 8, generator=g, device="cuda", dtype=torch.float64)
    return w, x0s.to(dtype)


@phase("kernels")
def kernels_phase(report):
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk

    def setup(dtype):
        w, x0s = main_inputs(dtype, B_MAIN, T_MAIN)
        spec = vk.extract_vsa_spec(w.problem, w.bounds)
        x0 = x0s.T.contiguous()
        xs = x0.expand(T_MAIN + 1, 8, B_MAIN).contiguous()
        us = torch.zeros(T_MAIN, 4, B_MAIN, dtype=dtype, device="cuda")
        wterm = torch.full((B_MAIN,), spec.w_goal_term, dtype=dtype, device="cuda")
        lb = torch.tensor(spec.lb, dtype=dtype, device="cuda")[:, None].expand(4, B_MAIN).contiguous()
        ub = torch.tensor(spec.ub, dtype=dtype, device="cuda")[:, None].expand(4, B_MAIN).contiguous()
        reg = torch.full((B_MAIN,), 1e-9, dtype=dtype, device="cuda")
        kprev = torch.zeros(T_MAIN, 4, B_MAIN, dtype=dtype, device="cuda")
        a = torch.ones(B_MAIN, dtype=dtype, device="cuda")
        return spec, x0, xs, us, wterm, lb, ub, reg, kprev, a, 0.5 * a

    def calls(dtype):
        spec, x0, xs, us, wterm, lb, ub, reg, kprev, aa, ab = setup(dtype)
        lin_p = vk.linearize_plain(spec, xs, us, wterm)
        r = lin_p.run
        bw_args = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                   lin_p.term["Lx"], lin_p.term["Lxx"], us, kprev, lb, ub, reg, 2)
        bw_p = rk.riccati_box_plain(*bw_args)
        roll_args = (spec, xs, us, bw_p.k, bw_p.K, x0, aa, ab, wterm, lb, ub)
        return {
            "linearize": (lambda: vk.linearize(spec, xs, us, wterm), lambda: lin_p,
                          lambda: vk.linearize_plain(spec, xs, us, wterm)),
            "riccati_box": (lambda: rk.riccati_box_backward(*bw_args), lambda: bw_p,
                            lambda: rk.riccati_box_plain(*bw_args)),
            "rollout2": (lambda: vk.rollout2(*roll_args), None,
                         lambda: vk.rollout2_plain(*roll_args)),
        }

    def flat(out):
        if hasattr(out, "run"):
            return ({f"run.{k}": v for k, v in out.run.items()}
                    | {f"term.{k}": v for k, v in out.term.items()}
                    | dict(cost=out.cost, xnext=out.xnext, ok=out.ok))
        if hasattr(out, "retryable"):
            return out._asdict()
        return {f"trial{i}.{f}": getattr(t, f) for i, t in enumerate(out)
                for f in ("xs", "us", "cost")}

    def compare(name, got, want, tol):
        worst_rel, worst_abs = 0.0, 0.0
        for key, w in flat(want).items():
            g = flat(got)[key]
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

    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, None)):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, (kern, plain_out, plain) in calls(dtype).items():
            got = kern()
            torch.cuda.synchronize()
            want = plain_out() if plain_out is not None else plain()
            rel, err = compare(name, got, want, tol)
            log(f"  {name} {tag}: kernel vs plain max rel err {rel:.3e}, max abs err {err:.3e}"
                + (f" (limit {tol:g}, flags equal)" if tol else ""))
            report[name][f"rel_err_{tag}"] = rel
            report[name]["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            if tag == "f32":
                report[name]["ms"] = cuda_ms(kern, 20)
                report[name]["plain_ms"] = cuda_ms(plain, 2)
                log(f"  {name} f32 time: kernel {report[name]['ms']:.4f} ms, "
                    f"plain {report[name]['plain_ms']:.4f} ms")


@phase("main path")
def main_path_phase(report, card):
    from aslr_to_tpu_torch import SolverSettings, convergence_summary, make_batched_solver
    from aslr_to_tpu_torch.kernels import build

    w, x0s = main_inputs(torch.float32, B_MAIN, T_MAIN)
    settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
    solve = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                use_fast_path="lanes")
    times = []
    for rep in range(2):
        if rep == 0:
            build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(x0s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = dict(build.LAUNCHES)
    log(f"  launches in the first main-path solve: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
        report[name]["launches"] = n
    assert res.xs.shape == (B_MAIN, T_MAIN + 1, 8) and res.us.shape == (B_MAIN, T_MAIN, 4)
    live = ~res.diverged
    if not bool(torch.isfinite(res.cost[live]).all()):
        raise AssertionError("non-finite cost in a lane that did not diverge")
    summ = convergence_summary(res)
    log(f"  convergence (card, f32): converged_frac {summ['converged_frac']}, "
        f"diverged_frac {summ['diverged_frac']}, mean_iterations {summ['mean_iterations']}, "
        f"median_cost {summ['median_cost']}")
    log(f"  for reference only, the TPU's f32 statistics on this config (BENCH_r05): "
        f"{TPU_REFERENCE}")
    for i, t in enumerate(times):
        log(f"  solve {i}: {t:.4f} s, {B_MAIN / t:.2f} solves/s on {card} "
            f"(T={T_MAIN}, B={B_MAIN}, f32, maxiter=20)")


@phase("parity")
def parity_phase():
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver

    w, x0s = main_inputs(torch.float64, B_PARITY, T_MAIN, seed=1)
    settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                    use_fast_path="lanes", backend=backend)
        t0 = time.perf_counter()
        res[backend] = solve(x0s)
        torch.cuda.synchronize()
        log(f"  {backend} backend: {time.perf_counter() - t0:.3f} s")
    k, p = res["auto"], res["plain"]
    same = ((k.iterations == p.iterations) & (k.converged == p.converged)
            & (k.diverged == p.diverged))
    n_same = int(same.sum())
    for lane in torch.nonzero(~same).flatten().tolist():
        log(f"  lane {lane} differs: kernel it={int(k.iterations[lane])} "
            f"conv={bool(k.converged[lane])} div={bool(k.diverged[lane])} "
            f"cost={float(k.cost[lane])}; plain it={int(p.iterations[lane])} "
            f"conv={bool(p.converged[lane])} div={bool(p.diverged[lane])} "
            f"cost={float(p.cost[lane])}")
    c_rel = ((k.cost - p.cost).abs() / p.cost.abs())[same]
    finite = torch.isfinite(c_rel)
    worst = float(c_rel[finite].max()) if bool(finite.any()) else 0.0
    log(f"  lanes equal in iterations and flags: {n_same}/{B_PARITY}; "
        f"max cost rel err in those lanes {worst:.3e}")
    if n_same < B_PARITY - 1:
        raise AssertionError(f"only {n_same} of {B_PARITY} lanes agree")
    if not worst <= 1e-8:
        raise AssertionError(f"cost rel err {worst:.3e} > 1e-8")


@phase("golden")
def golden_phase():
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_vsa_boxddp

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", "vsa_boxddp_T30.npz"))
    w = two_dof_vsa_boxddp(T=30, dtype=torch.float64, device="cuda")
    res = make_batched_solver(w.problem, SolverSettings(maxiter=25, th_stop=1e-7),
                              use_gaps=False, bounds=w.bounds)(
        torch.zeros(1, 8, dtype=torch.float64, device="cuda"))
    cost, iters = float(res.cost[0]), int(res.iterations[0])
    us_err = float(np.abs(res.us[0].cpu().numpy() - ref["us"]).max())
    log(f"  cost {cost} (golden {float(ref['cost'])}), iterations {iters} "
        f"(golden {int(ref['iters'])}), us max abs err {us_err:.3e}")
    if not (abs(cost - float(ref["cost"])) <= 1e-8 * abs(float(ref["cost"]))
            and iters == int(ref["iters"]) and us_err <= 1e-6):
        raise AssertionError("the T=30 solve does not reproduce the golden fixture")


def main():
    card, smi = device_phase()
    build_phase()
    report = {name: dict(name=name, route="cuda", **meta) for name, meta in KERNELS.items()}
    kernels_phase(report)
    main_path_phase(report, smi)
    parity_phase()
    golden_phase()
    log(json.dumps({"kernels": list(report.values())}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
