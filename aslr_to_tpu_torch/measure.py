"""The port's solver paths on the card, defined once: ``chip_smoke.py``
drives them, and this module's command line measures them (solves/s over
batch sizes and a ``torch.profiler`` breakdown of one solve).

    python -m aslr_to_tpu_torch.measure --path sea_warm --batch 1024 4096 16384
    python -m aslr_to_tpu_torch.measure --path boxddp boxfddp --batch 4096 --profile
    python -m aslr_to_tpu_torch.measure --path sevendof --profile
    python -m aslr_to_tpu_torch.measure --path sevendof_box fast_sevendof_box sevendof_ddp --profile
    python -m aslr_to_tpu_torch.measure --path mpc_tracking fast_mpc_tracking pk_boxddp --profile
    python -m aslr_to_tpu_torch.measure --path homotopy --profile
    python -m aslr_to_tpu_torch.measure --path double_pendulum --profile

Paths (T=100, float32, x0s = 0.05 randn from a CUDA generator seeded per
path, ``SEEDS``; B=4096 unless ``--batch`` or the path says otherwise):

  boxddp    BoxDDP on two_dof_vsa_boxddp, cold, maxiter=20, th_stop=1e-5,
            boxqp_warm_iters=2 (the benchmark's primary metric);
  sea_warm  FDDP on two_dof_sea: a cold solve (maxiter=60, th_stop=1e-5,
            untimed set-up), then timed warm re-solves from its (xs, us),
            the i-th at x0s + 1e-4 (i + 1) (the benchmark's converged
            headline, bench.py:180-200);
  boxfddp   BoxFDDP on two_dof_vsa_boxddp with the preset's box, cold,
            maxiter=20, th_stop=1e-5, boxqp_warm_iters=2;
  fast_boxddp  boxddp through the per-scenario solver's fast path
            (``use_fast_path=True``: K1, K2, K6), same preset, seed and
            settings;
  fast_sea  the sea_warm path's cold solve (seed 1, maxiter=60,
            th_stop=1e-5) through the fast path (K1, K4, K6);
  fast_sea_assoc  fast_sea with ``assoc_backward``: the log-depth
            backward (``solvers/assoc_riccati.py``, batched torch, no
            kernel) in place of K4, so K1 and K6 alone;
  sevendof  FDDP on seven_dof_sea (nx=28, nu=7), B=1024, warm-started
            from the quasi-static controls, maxiter=20, th_stop=1e-5 (the
            benchmark's 7-DoF metric, bench.py:231-252): K1, K4 and K3 at
            nl = 7;
  fast_sevendof  the sevendof solve through the fast path (K1, K4, K6 at
            nl = 7), same seed and settings;
  sevendof_box  the 7-DoF reach under the motors' torque limits: BoxFDDP
            on seven_dof_sea in the box [-SEVENDOF_BOX, SEVENDOF_BOX] (each
            joint's peak |u| in the unboxed reach from rest), B=1024,
            warm-started from the quasi-static controls (projected into the
            box), maxiter=20, th_stop=1e-5, boxqp_warm_iters=2 (the box
            paths' settings): K1, K5 at (28, 7) and K3 at nl 7 with the box
            and gaps; seed 8;
  fast_sevendof_box  the same solve through the fast path (K1, K5, K6);
  sevendof_ddp  the unboxed 7-DoF reach as DDP (use_gaps=False), B=1024,
            warm-started, maxiter=20, th_stop=1e-5: K1, K4 at (28, 7) with
            zero gaps and K3 at nl 7 without box or gaps; seed 8;
  fast_sevendof_ddp  the same solve through the fast path: K1, the
            generic backward (the family without box or gaps has no
            backward kernel, solvers/ddp.py::_backward) and K6 without box
            or gaps;
  mpc_tracking  the tracking MPC of examples/mpc_tracking.py: two_dof_sea at
            T=60 with the frame target at knot t on the arc ``mpc_target``
            (a per-knot problem, ``with_frame_targets``), FDDP, no box,
            maxiter=30, th_stop=1e-5, B=2048 (its MPC_BATCH): a first
            solve (untimed set-up), then timed solves from x0s + 1e-4 (i +
            1), as its bench_lane_batch does. K1 and K3 read the [T, 12]
            target table; K4;
  fast_mpc_tracking  the same solves through the fast path (K1, K4, K6
            with the table);
  pk_boxddp  BoxDDP on two_dof_vsa_boxddp stacked per knot, with [T, 4]
            box tables: every row [-2, 2]^2 x [0, 3]^2 but knots 45-54,
            whose torques are held to +-0.05; cold, maxiter=20,
            th_stop=1e-5, boxqp_warm_iters=2, B=4096. K1, K2 and K3 read
            the box tables;
  homotopy  the staged homotopy with the diverged-lane rescue (the
            benchmark's quality metric, bench.py:202-229): two_dof_vsa_boxddp,
            cold, BoxDDP with boxqp_warm_iters=2, maxiter=20 a stage,
            th_stop=1e-5, stiffness_continuation's 5 stages (the stiffness
            capped at 3 in the first four), then rescue_continuation's 7
            stages (capped at 1 in the first six) on the 512 lanes the
            main pass flagged diverged first (RESCUE_SIZE). A first solve
            (untimed set-up), then timed solves at x0s + 1e-4 (i + 1).
            K1, K2 and K3 on the lane route;
  homotopy_scales  the same solves with stiffness_continuation's scales
            only (no stage boxes, no rescue), on the lane route;
  fast_homotopy  homotopy_scales through the fast path (K1, K2, K6);
  double_pendulum  the soft-actuated double-pendulum swing-up of
            examples/double_pendulum.py (the preset, T=10, FDDP, no box,
            cold) at its budget, maxiter=100, th_stop=1e-9, over B=4096
            initial states: x0s = the preset's x0 [3.14, 0, ...] plus the
            path's 0.05 randn. The fast path refuses its actuation, so it
            runs on the generic route (use_fast_path=False) with
            use_pallas_backward=True: its FDDP backward is K4 at (8, 2). A
            first solve (untimed set-up), then timed solves at x0s + 1e-4
            (i + 1).

The lane paths run two trials a line-search round through K3; the fast
paths one trial a round through K6, with a relayout between the solver's
batch-major tensors and the kernels' lane layout at each kernel call.

The kernels are built before anything is timed. For each batch size the
path's set-up runs, then ``--reps`` timed solves, each ending in
``torch.cuda.synchronize()``; solves/s is B over the host wall time, and
each kernel's launches in the last timed solve are printed. The
convergence line adds the largest iteration count, which is the number of
loop passes the whole batch ran, and the count of lanes at each iteration
count. ``--profile`` traces the last timed solve once more (same inputs)
and prints each kernel's device time and launches, the device time of
everything else, the host syncs, and the device's idle share of the wall
time; the copy kernels (the fast paths' relayouts, mostly) are counted
apart from the rest of the glue. ``--save-lanes FILE`` writes, for
the sea_warm path at the first batch size, the inputs and results of the
first re-solve's lanes that ran to maxiter unconverged, with as many
converged lanes, to an ``.npz``. Output lines are plain text; the last line
is one JSON record of every run. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

SEVENDOF_PATHS = ("sevendof", "fast_sevendof", "sevendof_box", "fast_sevendof_box",
                  "sevendof_ddp", "fast_sevendof_ddp")
PATHS = ("boxddp", "sea_warm", "boxfddp", "fast_boxddp", "fast_sea", "fast_sea_assoc",
         *SEVENDOF_PATHS, "mpc_tracking", "fast_mpc_tracking", "pk_boxddp", "homotopy",
         "homotopy_scales", "fast_homotopy", "double_pendulum")
SEEDS = dict(boxddp=0, sea_warm=1, boxfddp=2, fast_boxddp=0, fast_sea=1, fast_sea_assoc=1,
             sevendof=3, fast_sevendof=3, mpc_tracking=4, fast_mpc_tracking=4, pk_boxddp=5,
             homotopy=6, homotopy_scales=6, fast_homotopy=6, double_pendulum=7, sevendof_box=8,
             fast_sevendof_box=8, sevendof_ddp=8, fast_sevendof_ddp=8)
HOMOTOPY_PATHS = ("homotopy", "homotopy_scales", "fast_homotopy")
RESCUE_SIZE = 512       # bench.py's RESCUE
T_PATH, B_PATH = 100, 4096
B_SEVENDOF = 1024       # bench.py's BENCH_7DOF_BATCH
T_MPC, B_MPC = 60, 2048  # examples/mpc_tracking.py: its horizon and MPC_BATCH
MPC_SOLVES = 3          # its bench_lane_batch's timed solves
PINCHED = range(45, 55)  # pk_boxddp's knots whose torques are held to +-0.05
PINCH = 0.05
T_PENDULUM, MAXITER_PENDULUM = 10, 100   # examples/double_pendulum.py's horizon and budget
TIGHT_BOX = ([-2.0, -2.0, 0.0, 0.0], [2.0, 2.0, 3.0, 3.0])
# the 7-DoF reach's torque limits (sevendof_box: the box [-SEVENDOF_BOX,
# SEVENDOF_BOX]): each joint's peak |u| in the unboxed reach from rest (the
# sevendof solve from x0 = 0, the lane route in f64 on the CPU, converged in
# 10 iterations: [0.7974, 10.0935, 0.9982, 1.8678, 1.6883, 1.3584, 0.5888])
# rounded to 0.05, the limits that the unconstrained plan just touches
SEVENDOF_BOX = (0.8, 10.1, 1.0, 1.85, 1.7, 1.35, 0.6)
WARM_OFFSET = 1e-4
KERNEL_NAMES = ("linearize_kernel", "riccati_box_kernel", "riccati_boxfddp_kernel",
                "riccati_fddp_kernel", "rollout2_kernel", "rollout1_kernel")


class Path(NamedTuple):
    """A solver path: ``setup()`` runs its untimed set-up and returns what
    ``args(i, setup_result)`` needs to give the arguments of the i-th timed
    ``solve``."""
    solve: Callable
    setup: Callable
    args: Callable
    maxiter: int


def x0_batch(B, dtype, seed, nx=8):
    """x0s = 0.05 randn [B, nx] from a seeded CUDA generator, drawn in
    float64 so that both dtypes see the same states."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (0.05 * torch.randn(B, nx, generator=g, device="cuda", dtype=torch.float64)).to(dtype)


def mpc_target(t, T):
    """The tracking MPC's frame target at knot t of T: the arc
    [0.01, 0.05 + 0.15 t / T, 0.18] of examples/mpc_tracking.py."""
    return np.array([0.01, 0.05 + 0.15 * t / T, 0.18])


def path_batch(name):
    """The path's own batch: 1024 for the 7-DoF paths, 2048 for the MPC, else
    4096."""
    if name in SEVENDOF_PATHS:
        return B_SEVENDOF
    return B_MPC if name.endswith("mpc_tracking") else B_PATH


def path_T(name):
    """The path's horizon: 60 for the MPC, 10 for the pendulum, else 100."""
    if name == "double_pendulum":
        return T_PENDULUM
    return T_MPC if name.endswith("mpc_tracking") else T_PATH


def mpc_problem(T=T_MPC, dtype=torch.float32, device="cuda"):
    """The tracking MPC's per-knot problem: two_dof_sea with knot t's frame
    target at ``mpc_target(t, T)`` (the target's rotation the identity)."""
    from .workloads.presets import two_dof_sea, with_frame_targets

    rot = np.tile(np.eye(3), (T, 1, 1))
    trans = np.stack([mpc_target(t, T) for t in range(T)])
    return with_frame_targets(two_dof_sea(T=T, dtype=dtype, device=device).problem, rot, trans)


def pinched_box(T=T_PATH, dtype=torch.float32, device="cuda", knots=PINCHED):
    """pk_boxddp's [T, 4] box tables: the tight box at every knot, the
    torques of ``knots`` (45-54) held to +-0.05."""
    from . import Bounds

    lb, ub = (np.tile(np.asarray(b), (T, 1)) for b in TIGHT_BOX)
    for t in knots:
        lb[t, :2], ub[t, :2] = -PINCH, PINCH
    return Bounds(*(torch.as_tensor(b, dtype=dtype, device=device) for b in (lb, ub)))


def sevendof_bounds(dtype=torch.float32, device="cuda"):
    """The sevendof_box paths' shared [7] box, [-SEVENDOF_BOX, SEVENDOF_BOX]."""
    from . import Bounds

    ub = torch.tensor(SEVENDOF_BOX, dtype=dtype, device=device)
    return Bounds(-ub, ub)


def sevendof_solver(name, T=T_PATH, dtype=torch.float32, device="cuda", backend="auto",
                    maxiter=20, boxqp_warm_iters=2, use_fast_path=None, keep_log=False):
    """The solver of a 7-DoF path (``SEVENDOF_PATHS``) at horizon T: FDDP, or
    BoxFDDP in ``sevendof_bounds`` (``*_box``, with ``boxqp_warm_iters``),
    or DDP (``*_ddp``); the fast route for ``fast_*``, else the lane route
    (``use_fast_path`` given: that route); warm-started from the
    quasi-static controls, th_stop=1e-5; ``keep_log`` keeps the
    per-iteration series."""
    from . import SolverSettings, make_batched_solver, seven_dof_sea

    w = seven_dof_sea(T=T, dtype=dtype, device=device)
    box = name.endswith("_box")
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-5,
                              boxqp_warm_iters=boxqp_warm_iters if box else 0)
    return make_batched_solver(w.problem, settings, use_gaps=not name.endswith("_ddp"),
                               bounds=sevendof_bounds(dtype, device) if box else None,
                               warm_start=True, keep_log=keep_log,
                               use_fast_path=(use_fast_path if use_fast_path is not None else
                                              True if name.startswith("fast_") else "lanes"),
                               backend=backend)


def build_path(name, B=None, T=None, dtype=torch.float32):
    from . import SolverSettings, make_batched_solver, stack_knots, two_dof_sea
    from . import two_dof_vsa_boxddp

    B = B or path_batch(name)
    T = T or path_T(name)
    if name == "double_pendulum":
        w, solve = pendulum_solver(T, dtype)
        x0s = pendulum_x0s(w, B, SEEDS[name])
        return Path(solve, lambda: solve(x0s), lambda i, _: (x0s + WARM_OFFSET * (i + 1),),
                    MAXITER_PENDULUM)
    if name in ("mpc_tracking", "fast_mpc_tracking"):
        x0s = x0_batch(B, dtype, SEEDS[name])
        solve = make_batched_solver(mpc_problem(T, dtype), SolverSettings(maxiter=30, th_stop=1e-5),
                                    use_gaps=True, bounds=None,
                                    use_fast_path=True if name == "fast_mpc_tracking" else "lanes")
        return Path(solve, lambda: solve(x0s),
                    lambda i, _: (x0s + WARM_OFFSET * (i + 1),), 30)
    if name == "pk_boxddp":
        w = two_dof_vsa_boxddp(T=T, dtype=dtype)
        problem = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * T),
                                      per_knot=True)
        x0s = x0_batch(B, dtype, SEEDS[name])
        settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
        solve = make_batched_solver(problem, settings, use_gaps=False,
                                    bounds=pinched_box(T, dtype), use_fast_path="lanes")
        return Path(solve, lambda: None, lambda i, _: (x0s,), 20)
    if name in SEVENDOF_PATHS:
        x0s = x0_batch(B, dtype, SEEDS[name], nx=28)
        return Path(sevendof_solver(name, T, dtype), lambda: None, lambda i, _: (x0s,), 20)
    x0s = x0_batch(B, dtype, SEEDS[name])
    if name in HOMOTOPY_PATHS:
        solve = homotopy_solver(name, T, dtype)
        return Path(solve, lambda: solve(x0s), lambda i, _: (x0s + WARM_OFFSET * (i + 1),), 20)
    if name in ("sea_warm", "fast_sea", "fast_sea_assoc"):
        w = two_dof_sea(T=T, dtype=dtype)
        settings = SolverSettings(maxiter=60, th_stop=1e-5,
                                  assoc_backward=name == "fast_sea_assoc")
        solve = make_batched_solver(w.problem, settings, use_gaps=True, bounds=None,
                                    use_fast_path="lanes" if name == "sea_warm" else True)
        if name != "sea_warm":
            return Path(solve, lambda: None, lambda i, _: (x0s,), 60)
        return Path(solve, lambda: solve(x0s),
                    lambda i, cold: (x0s + WARM_OFFSET * (i + 1), cold.xs, cold.us), 60)
    w = two_dof_vsa_boxddp(T=T, dtype=dtype)
    settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
    solve = make_batched_solver(w.problem, settings, use_gaps=name == "boxfddp",
                                bounds=w.bounds,
                                use_fast_path=True if name == "fast_boxddp" else "lanes")
    return Path(solve, lambda: None, lambda i, _: (x0s,), 20)


def pendulum_solver(T=T_PENDULUM, dtype=torch.float32, device="cuda",
                    use_pallas_backward=True, maxiter=MAXITER_PENDULUM, keep_log=False):
    """The double-pendulum preset and its path's solver: the generic route,
    FDDP without a box, cold, th_stop=1e-9; ``use_pallas_backward`` sends
    the backward to K4 (else the generic sweep). Returns (workload,
    solver)."""
    from . import SolverSettings, double_pendulum, make_batched_solver

    w = double_pendulum(T=T, dtype=dtype, device=device)
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-9,
                              use_pallas_backward=use_pallas_backward)
    return w, make_batched_solver(w.problem, settings, use_gaps=True, bounds=None,
                                  keep_log=keep_log, use_fast_path=False)


def pendulum_x0s(w, B, seed=SEEDS["double_pendulum"]):
    """The pendulum path's initial states: the preset's x0 (hanging) plus
    ``x0_batch``'s 0.05 randn."""
    x0 = w.problem.x0
    return x0 + x0_batch(B, x0.dtype, seed, nx=x0.shape[-1])


def homotopy_solver(name, T=T_PATH, dtype=torch.float32, device="cuda", backend="auto",
                    maxiter=20, rescue_size=RESCUE_SIZE):
    """The solver of a homotopy path (``HOMOTOPY_PATHS``) at horizon T."""
    from . import SolverSettings, make_batched_solver, rescue_continuation
    from . import stiffness_continuation, two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=T, dtype=dtype, device=device)
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-5, boxqp_warm_iters=2)
    scales, ub_stages = stiffness_continuation(w.problem, w.bounds)
    kw = dict(scales=scales)
    if name == "homotopy":
        rescue_scales, rescue_ub = rescue_continuation(w.problem, w.bounds)
        kw.update(ub_stages=ub_stages, rescue_scales=rescue_scales, rescue_ub_stages=rescue_ub,
                  rescue_size=rescue_size)
    return make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                               use_fast_path=True if name == "fast_homotopy" else "lanes",
                               globalization="homotopy", backend=backend, **kw)


def summary(res):
    from . import convergence_summary

    summ = convergence_summary(res)
    summ["max_iterations"] = int(res.iterations.max())
    hist = torch.bincount(res.iterations.long()).tolist()
    summ["lanes_by_iterations"] = {i: n for i, n in enumerate(hist) if n}
    return summ


def save_lanes(fname, args, res, maxiter):
    """The inputs and results of the lanes that ran to ``maxiter``
    unconverged, and of as many converged lanes, to an ``.npz``."""
    stuck = torch.nonzero((res.iterations == maxiter) & ~res.converged).flatten()
    conv = torch.nonzero(res.converged).flatten()[:max(len(stuck), 1)]
    lanes = torch.cat([stuck, conv])
    x0s, xs, us = args

    def pick(t):
        return t[lanes].cpu().numpy()

    np.savez(fname, lanes=lanes.cpu().numpy(), n_stuck=len(stuck), x0s=pick(x0s),
             xs_init=pick(xs), us_init=pick(us), iterations=pick(res.iterations),
             converged=pick(res.converged), diverged=pick(res.diverged), cost=pick(res.cost),
             stop=pick(res.stop))
    print(f"  saved {len(stuck)} lanes at maxiter and {len(conv)} converged lanes to {fname}",
          flush=True)


def _device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def profile_solve(solve, inputs):
    """Device time by kernel, host syncs and idle share of one solve."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {k: dict(ms=0.0, launches=0) for k in KERNEL_NAMES}
    copies = dict(ms=0.0, launches=0)
    other = dict(ms=0.0, launches=0)
    syncs = 0
    for evt in prof.key_averages():
        if evt.key == "cudaStreamSynchronize":
            syncs += evt.count
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        row = next((kernels[k] for k in KERNEL_NAMES if k in evt.key),
                   copies if "copy" in evt.key.lower() else other)
        row["ms"] += _device_us(evt) / 1e3
        row["launches"] += evt.count
    busy = sum(r["ms"] for r in kernels.values()) + copies["ms"] + other["ms"]
    return dict(wall_ms=wall_ms, device_ms=busy, idle_share=1.0 - busy / wall_ms,
                host_syncs=syncs, kernels=kernels, copy_device=copies, other_device=other)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=PATHS, nargs="+", required=True)
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batch sizes (default: each path's own, 4096 or 1024)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--save-lanes", metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the measurements are of the card")
    from .kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.build()
    build.lib()
    record = dict(card=card, runs=[])
    batches = {p: args.batch or [path_batch(p)] for p in args.path}
    for path, B in ((p, b) for p in args.path for b in batches[p]):
        p = build_path(path, B)
        prep = p.setup()
        times = []
        for i in range(args.reps):
            inputs = p.args(i, prep)
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            res = p.solve(*inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0 and args.save_lanes and path == "sea_warm" and B == batches[path][0]:
                save_lanes(args.save_lanes, inputs, res, p.maxiter)
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        summ = summary(res)
        run = dict(path=path, B=B, seconds=times, solves_per_s=[B / t for t in times],
                   launches=launches, **summ)
        print(f"{path} B={B}: " + ", ".join(f"{t:.4f} s ({B / t:.2f} solves/s)"
                                                 for t in times), flush=True)
        print(f"  kernel launches in the last solve: {launches}", flush=True)
        print(f"  convergence of the last solve: {summ}", flush=True)
        stats = getattr(p.solve, "stats", None)
        if stats:       # the homotopy's main pass and rescue, apart
            run["homotopy"] = dict(main_s=stats["main_s"], rescue_s=stats["rescue_s"],
                                   main_diverged=int(stats["main_diverged"]),
                                   rescued=int(stats["rescued"]))
            print(f"  main pass {stats['main_s']:.4f} s, rescue {stats['rescue_s']:.4f} s, "
                  f"lanes diverged after the main pass {int(stats['main_diverged'])}, "
                  f"rescued {int(stats['rescued'])}", flush=True)
        if args.profile:
            prof = profile_solve(p.solve, inputs)
            run["profile"] = prof
            print(f"  profile: wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, "
                  f"idle share {prof['idle_share']:.4f}, host syncs {prof['host_syncs']}",
                  flush=True)
            for k, r in list(prof["kernels"].items()) + [("copies", prof["copy_device"]),
                                                         ("other", prof["other_device"])]:
                if r["launches"]:
                    print(f"    {k}: {r['ms']:.3f} ms in {r['launches']} launches", flush=True)
        record["runs"].append(run)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
