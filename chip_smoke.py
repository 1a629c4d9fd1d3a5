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
     times from CUDA events after a warm-up, the plain version's on the
     call compared in f32; the least time the
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
     B=4096 (K3 at nl 7, in its other layout there, held to the bit again
     in f64 and f32 by a worker), with the plain version's time at B=1024
     and the bound;
     n-DoF box kernels: the launch and ptxas line of K5 at (28, 7) and of
     K3 / K6 at nl 7 in DDP's variant (no box, no gaps) and BoxFDDP's (box
     and gaps) at B=1024 and 4096 in f32 and f64; K5 at (12, 3) and (28, 7)
     and those rollouts at nl 3 and 7 to the bit against their plain
     versions in f64 and f32 at T=100, B=1024, in a box that binds (the
     7-DoF box path's, ±0.5 at nl 3; its binding share printed), K5 also on
     a solver iterate's inputs (the sevendof_box lane solve after 3
     passes), timed in f32 with the plain version's time and the bound;
     K3 at nl 7 held to the bit again at B=4096 (its general layout) by a
     worker, and every new instance timed there;
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
     lane: BoxDDP and SEA FDDP (B=256, T=40, maxiter 20), BoxFDDP in a
     tight box (B=128, T=40, maxiter 10);
  8. golden: the T=30 BoxDDP solve against tests/golden/vsa_boxddp_T30.npz
     and the quasi-static-warm T=100 SEA FDDP solve against
     tests/golden/sea_T100.npz, both float64 through the kernels (and the
     T=100 homotopy, phase 13);
  9. 7-DoF: FDDP on seven_dof_sea (nx=28, nu=7), B=1024, T=100, float32,
     warm-started from the quasi-static controls, maxiter=20, th_stop=1e-5
     (bench.py:231-252): the lane route (K1, K4, K3 at nl = 7), two timed
     solves with solves/s and the convergence accounting beside the TPU's
     converged fraction; the fast route (K1, K4, K6) on the same inputs,
     within 3 points (1.5 mean iterations) of the lane route; the generic
     route in float64 at T=10, B=16, maxiter=3 against both (at least B-1
     lanes agree);
     7-DoF box and DDP: the 7-DoF reach under the motors' torque limits
     (measure.py paths sevendof_box and fast_sevendof_box: BoxFDDP in the
     box ±SEVENDOF_BOX, warm QPs of 2 iterations; K1, K5 at (28, 7), K3 or
     K6 with the box and gaps) and as DDP (sevendof_ddp: K1, K4 with zero
     gaps, K3 without box or gaps), B=1024, T=100, f32, warm-started: a
     first solve and two timed ones each, with solves/s, the convergence
     accounting and the share of the final controls on a bound (above 0,
     or the phase fails); the fast BoxFDDP route's statistics beside the
     lane route's, not gated (the solve is chaotic at T=100); the fast DDP
     route once (K6 without box or gaps), within 3 points of its lanes;
     workers hold each of the four routes through its kernels to the same
     route through the plain versions in f64 (B=64, T=10, maxiter 20; the
     parity criterion, and the lanes equal to the bit counted; at T=100 a
     route's plain backend takes 13-20 min beside the other workers, so
     that horizon runs alone: ``--check "parity 7-DoF BoxFDDP lanes
     T=100"`` and so on), and the lane and fast routes to the generic one
     in f64 at T=10, B=16, maxiter 20, with cold QPs (at least B-1 lanes
     agree; in BoxFDDP a lane also counts whose logs agree up to a control
     that the routes' feedback sums put on a bound in one route and one
     rounding inside it in the other);
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
 13. homotopy: the staged homotopy with the diverged-lane rescue
     (measure.py path homotopy, the benchmark's quality metric,
     bench.py:202-229): two_dof_vsa_boxddp, T=100, B=4096, f32, cold,
     maxiter=20 a stage, th_stop=1e-5, boxqp_warm_iters=2,
     stiffness_continuation's 5 stages and rescue_continuation's 7 on
     RESCUE_SIZE=512 lanes, on the lane route (K1, K2, K3): a first solve,
     then two timed solves at x0s + 1e-4 (i + 1), with solves/s, the main
     pass's and the rescue's seconds apart, the lanes rescued and the
     convergence accounting beside the TPU's (median cost 574.68, 0.98%
     diverged; BENCH_r05); then the fast route's homotopy (K1, K2, K6) and
     the lane route's on the same inputs with the same scales and no stage
     boxes, within 3 points (1.5 mean iterations) of each other. The
     stage-box kernels phase (after the kernels phase) holds K2 and K3 at
     the first stage's box (stiffness capped at 3) and the rescue's (capped
     at 1), T=100, B=4096, to their plain versions to the bit in f64 and
     f32, timed, with their bound; two workers hold the homotopy with
     rescue in f64 through the kernels to its plain backend lane by lane
     (T=20, B=64, maxiter 10 a stage, rescue_size 16, one lane at x0 =
     inf: its main pass in one, its rescue pass on the lanes the kernels
     pick in the other, with the kernels' rescued solve held to the merge
     of the two passes), and
     the golden phase runs the configuration of
     tests/golden/vsa_homotopy_T100.npz through the kernels in f64 and
     holds it to the JAX package's lane route on it
     (tests/data_torch/vsa_homotopy_T100_lanes.npz; the golden, JAX's
     generic route, is 0.31% away from both lane routes and is printed);
 14. generic: the generic solver (use_fast_path=False, the reference),
     the fast path and the lane path in float64 at T=40, B=64, maxiter=20
     (BoxDDP in the tight box with cold QPs, SEA FDDP), at least B-1 lanes
     equal in iterations and flags with cost within rtol 1e-8 (a lane
     diverged in both excepted) pairwise, a lane whose generic and fast
     logs part re-run to the parting with the controls that sit on a
     bound in one route only printed; one timed f32 solve of each
     route at T=100, B=256 with the main path's settings and maxiter=2
     (BoxDDP); the T=30 BoxDDP golden through SolverBoxDDP (with phase 8);
 15. double pendulum: the soft-actuated swing-up of
     examples/double_pendulum.py (measure.py path double_pendulum: the
     preset at T=10, FDDP, no box, cold, maxiter=100, th_stop=1e-9, B=4096,
     f32, x0s the hanging x0 plus 0.05 randn, seed 7) on the generic route,
     whose FDDP backward is K4 at (8, 2) (use_pallas_backward=True; the fast
     path refuses the underactuated actuation): a first solve, then one
     timed solve at x0s + 1e-4 with solves/s and the convergence
     accounting, K4 the only kernel launched, its launches a solve, and its
     launches and device time by torch.profiler over the first 10 passes. The
     pendulum kernels phase (after the
     n-DoF kernels) holds K4 on the path's data to its plain version to the
     bit in f64 and f32, ok and retryable included, at the cold start and at
     the first pass of PENDULUM_PASSES where Quu fails to factor on some
     lanes only (k[:, 1] and K[:, 1] exactly 0 where a lane factors), timed
     at B=4096 and 16384 (device time by torch.profiler, the events' beside)
     with its bound; a worker holds the K4 route in f64
     (T=10, B=64, maxiter 100) to the bit against the same route through
     K4's plain version, its every backward's ok and retryable to the
     generic sweep's on the same linearization and its k, K, w and sums
     within rtol 1e-7, and at least B-1 lanes to the generic sweep's
     iterations and flags, with costs within rtol 1e-8 and equal steps and
     regularizations over the first 16 passes, the final costs reported
     (they part by amplified rounding in this solve, which does not
     converge); the
     north-star solve (one f64 scenario from the preset's x0
     through run_workload at the reference's budget) is held to
     docs/northstar.json's cost within rtol 1e-6;
 16. assoc: the log-depth backward (solvers/assoc_riccati.py, batched
     torch, no kernel) against the generic route's sequential sweep
     (solvers/ddp.py::_backward_scan) and K4 at (8, 4) alone, on
     scripts/bench_assoc.py's data (ndx 8, nu 4) in f32 at T 128 and 1024,
     B 8 and 1024 (ASSOC_T, ASSOC_B): CUDA events over ASSOC_REPS calls
     after a warm-up, the gains of assoc and of K4 each within
     ASSOC_GAIN_RTOL of the sequential sweep's or the phase fails;
     fast assoc: the fast route's SEA cold solve with assoc_backward
     (measure.py path fast_sea_assoc, T=100, B=4096, f32, maxiter 60: K1
     and K6 launched, no backward kernel, or the phase fails) beside the
     same route without it (fast_sea), both timed with their statistics,
     which may part by no more than FAST_ASSOC_GAPS;
     sharded: sharded_solve over the host's cards on the BoxDDP main path
     (its problem, settings and x0s), the shards in series in this
     process, equal to the lane solve to the bit;
     entry points: aslr_to_tpu_torch/entry.py's entry() fn on its example
     x0s and dryrun_multichip over the host's cards (the five families,
     the shards in series);
     a worker holds the generic route's SEA FDDP with assoc_backward to the
     sequential backward in f64 (T=20, B=64, maxiter 8: every lane's
     iterations and flags equal, cost within rtol 1e-9, us within atol
     1e-7), and runs each example's main at its CPU test's sizes.

The spmd phase runs first after the build, as the check workers start:
the sharded solve across processes (aslr_to_tpu_torch/parallel/spmd.py),
a rank a card over NCCL on a host with several cards, else 2 ranks on card
0 over Gloo, started by aslr_to_tpu_torch/parallel/launch.py as
``python3 chip_smoke.py --spmd-rank DIR``; each runs the BoxDDP main
path's problem, settings and x0s through shard_map_solve on the lane
route, a warm-up solve, then one solve timed from a barrier to a barrier
after the gathered result with the check workers stopped. Every rank must
launch K1, K2 and K3 from its own card's library (no _device_copy), its
gathered result must equal this process's lane solve of the same x0s to
the bit, and the global statistics (n_conv, mean_cost) must agree on
every rank and equal those computed in the same way from the lane solve.

Phases 7, 8 and 14 (and the f64 parity of 12, of the homotopy, of the
pendulum and of the 7-DoF routes, K3 at nl 7 held to the bit at B=4096,
and the north-star solve) solve on the plain backend and the generic
route, whose thousands of small kernels a loop pass wait on the host and
leave the card idle, or check without timing. So they run in worker
processes of their own (``python3 chip_smoke.py --check NAME ...``,
CHECK_WORKERS), started once the build is done at a lower priority (nice
10), side by side with each other and with every phase of this process,
which stops them (SIGSTOP) while it times a kernel or a solve and lets
them go on (SIGCONT) after it, so that each time is taken with the card
and the host to itself; at the end it prints each worker's output and
fails if a worker failed. A time that a check prints is its wall time
beside the others. The kernel phases time each plain version on the call
that was compared in f32, and count its operations on the f64 one.

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
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# the TPU's f32 statistics (the JAX package's benchmark record
# BENCH_r05.json), printed beside the card's for reference only
# the 7-DoF paths' solves/s recorded before the nl 7 rollouts were
# redesigned (PERF.md and CHANGES.md: this script's runs, the reach's by
# measure.py; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
RECORDED_SOLVES_PER_S = dict(sevendof="2,519.63", sevendof_box="1,740.08-1,810.17",
                             fast_sevendof_box="1,044.19-1,054.67",
                             sevendof_ddp="1,950.57-2,014.23")
TPU_REFERENCE = dict(boxddp=dict(converged_frac=0.0, diverged_frac=0.211, mean_iterations=18.4),
                     sea_warm=dict(converged_frac=0.9998),
                     sevendof=dict(converged_frac=0.9316, solves_per_s_on_tpu=1984.58),
                     homotopy=dict(median_cost=574.68, diverged_frac=0.0098,
                                   solves_per_s_on_tpu=4878.11))
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
    # K5 at (28, 7), the 7-DoF arm in a torque box (its wide layout); K5 at
    # (12, 3) is its variant, and the rollouts' DDP ("sea") and BoxFDDP
    # ("sea box gaps") instances at nl 3 and 7 are variants of the rows
    # rollout2_n7 and rollout1_n7
    "riccati_boxfddp_n7": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                               replaces="aslr_to_tpu/pallas/riccati.py:294"),
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
    # K2 and K3 at the homotopy's stage boxes: the stiffness channels capped
    # at 3 (stiffness_continuation's first four stages) and at 1 (the
    # rescue's first six); launches those of the capped stages
    "riccati_box:cap3": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                             replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "riccati_box:cap1": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                             replaces="aslr_to_tpu/pallas/riccati.py:200"),
    "rollout2:cap3": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                          replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    "rollout2:cap1": dict(source="aslr_to_tpu_torch/csrc/rollout.cu",
                          replaces="aslr_to_tpu/pallas/vsa_kernels.py:476"),
    # K4 at (8, 2) on the double pendulum's data (T=10; a zero Fu column,
    # Quu failing to factor on some lanes), launched by the generic route
    "riccati_fddp:pendulum": dict(source="aslr_to_tpu_torch/csrc/riccati_box.cu",
                                  replaces="aslr_to_tpu/pallas/riccati.py:294"),
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
            "rollout1_n7": "fast_sevendof", "riccati_boxfddp_n7": "sevendof_box",
            "linearize:target_table": "mpc_tracking",
            "rollout2:target_table": "mpc_tracking", "rollout1:target_table": "fast_mpc_tracking",
            "riccati_box:box_table": "pk_boxddp", "rollout2:box_table": "pk_boxddp",
            "riccati_boxfddp:box_table": "pk_parity_boxfddp",
            "rollout1:box_table": "pk_parity_fast_boxddp", "riccati_box:cap3": "homotopy",
            "riccati_box:cap1": "homotopy", "rollout2:cap3": "homotopy",
            "rollout2:cap1": "homotopy", "riccati_fddp:pendulum": "double_pendulum"}
# the launch counter (build.LAUNCHES) of each row, and the paths that run
# the 7-DoF instances and the per-knot tables
ROW_KERNEL = {row: row.split(":")[0].removesuffix("_n7") for row in ROW_PATH}
NDOF_PATHS = ("sevendof", "fast_sevendof", "sevendof_box", "fast_sevendof_box", "sevendof_ddp",
              "fast_sevendof_ddp")
TABLE_ROWS = tuple(row for row in ROW_PATH if row.endswith("_table"))
# the stage-box rows: their launches come from the homotopy's stages
# (homotopy_phase), the stages each cap runs in
STAGE_ROWS = {row: row.split(":")[1] for row in ROW_PATH if ":cap" in row}
CAP_STAGES = dict(cap3=("main", range(4)), cap1=("rescue", range(6)))
# the homotopy's f64 parity: at T=40 each pass's plain backend took 390-420
# s beside the other workers on an H100
B_HOMOTOPY_PARITY, T_HOMOTOPY_PARITY, MAXITER_HOMOTOPY_PARITY = 64, 20, 10
RESCUE_HOMOTOPY_PARITY, INF_LANE = 16, 5
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
# the 7-DoF box and DDP paths: the 3-DoF arm's box in the kernel phase
# (tests/test_torch_ndof_box.py's), the kernel iterate's passes, the f64
# parity of each route through its kernels against its plain backend, and
# the lane and fast routes against the generic one (T=10, where the routes
# agree; at T=100 the boxed solve is chaotic)
BOX_SEA3 = (0.5, 0.5, 0.5)
NDOF_ITERATE_PASSES = 3
# the parity's horizon in the workers: a pass of the plain backend at T=100
# is tens of seconds of small launches at nl 7 (a T=100 route took 767-1,194
# s beside the other workers on an H100, and the four at T=20 300-565 s), so
# the workers hold T=10, where the routes also meet the generic one; the
# checks "parity 7-DoF ... T=100" run the path's horizon, one a command
B_NDOF_PARITY, MAXITER_NDOF_PARITY, T_NDOF_PARITY = 64, 20, 10
B_NDOF_BOX_GENERIC, MAXITER_NDOF_BOX_GENERIC = 16, 20
# the lane route's and the fast route's path of each 7-DoF family
NDOF_FAMILIES = {"BoxFDDP": ("sevendof_box", "fast_sevendof_box"),
                 "DDP": ("sevendof_ddp", "fast_sevendof_ddp")}
# the cases also timed at B_FILL
FILL_CASE = ROW_CASE + ("linearize[sea]", "riccati_fddp[vsa]")
# kernels held to their plain versions to the bit (the others to 1e-9 in f64)
BIT_EXACT = ("linearize", "riccati_fddp", "rollout2", "rollout1")
PROBE_ROW = dict(B=1048576, ilp=1, mode="mul_add")
NO_LIBRARY = ("no single PyTorch call computes this function (a serial per-scenario "
              "recursion); no stand-in timed")
# BoxDDP and SEA FDDP parity at T_PARITY (the main path's T=100 took
# their plain backends 150-410 s beside the other workers on an H100), and
# BoxFDDP's in a tight box
B_PARITY, T_PARITY, B_PARITY_BOX, T_PARITY_BOX = 256, 40, 128, 40
T_GENERIC, B_GENERIC, B_TIMED, MAXITER_TIMED = 40, 64, 256, 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12              # H100 SXM float64 outside the tensor cores (data sheet)
REG = 1e-9
B_FILL = 16384                     # the kernels' batch-filling variant
# the associative backward's timing grid (scripts/bench_assoc.py's shape,
# ndx 8 and nu 4) and its calls timed after a warm-up
ASSOC_T = (128, 1024)
ASSOC_B = (8, 1024)
ASSOC_REPS = 3
ASSOC_GAIN_RTOL = 1e-4
# the most the fast SEA route with assoc_backward may part from it without
FAST_ASSOC_GAPS = dict(converged_frac=0.02, diverged_frac=0.02, mean_iterations=1.0,
                       max_iterations=10, median_cost=1e-3)
# the double pendulum: the passes of the path's solve tried for K4's
# mid-solve inputs (the first at which Quu fails to factor on some lanes
# and factors on others), the f64 parity's batch, and the north-star record
PENDULUM_PASSES = (8, 12, 16, 24, 32, 48)
B_PENDULUM_PARITY = 64
# the pendulum's f64 parity: K4's sweep against the generic sweep on one
# linearization (largest per-lane relative difference 5.2e-9 on the H100),
# and the passes over which the two routes' cost logs are held within rtol
# 1e-8 (in this solve, which does not converge, rounding differences grow
# to 1e-8 from pass 18 on)
PENDULUM_SWEEP_RTOL = 1e-7
PENDULUM_LOG_PASSES = 16
PENDULUM_PROFILED = 10             # the passes traced for K4's device time
# the pendulum path's timed solves after its first (each 19-30 s of the
# generic route's launches on an H100, with the workers stopped)
PENDULUM_TIMED = 1
NORTHSTAR = os.path.join("docs", "northstar.json")
# the spmd phase's ranks: each one's start-up, warm-up solve and timed solve
# (the library is built by then), in seconds
SPMD_TIMEOUT_S = 300
SPMD_KERNELS = ("linearize", "riccati_box", "rollout2")


def log(msg):
    print(msg, flush=True)


# the check workers that run beside this process (start_checks), and the
# seconds a stopped worker is given for the launches it queued to drain
WORKERS = []
DRAIN_S = 0.02
WORKER_NICE = 10


@contextmanager
def quiet():
    """Stop every running check worker (SIGSTOP) for a timed section and
    let them go on after it (SIGCONT), so that the card and the host are
    this process's alone while it times; in a worker, nothing."""
    live = [proc for _, proc, _ in WORKERS if proc.poll() is None]
    for proc in live:
        proc.send_signal(signal.SIGSTOP)
    if live:
        time.sleep(DRAIN_S)
    try:
        yield
    finally:
        for proc in live:
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)


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
    with quiet():
        fn()                                # warm-up
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

    with quiet():
        fn()
        torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    counts, fullest = [], (0, 0.0)
    for _ in range(3):
        with quiet(), profile(activities=[ProfilerActivity.CUDA]) as prof:
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


class _ShortQueue(TorchFunctionMode):
    """Waits for the card every 32 torch calls, so that a worker stopped by
    quiet() leaves at most that many of its small kernels queued (what
    CUDA_LAUNCH_BLOCKING=1 bounded to one, at a wait a launch: 10x the time
    of the nl 7 checks at B=4096 beside the other workers)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        if self.calls % 32 == 0:
            torch.cuda.synchronize()
        return out


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


def counted(fn):
    """``fn()`` and the elementwise arithmetic operations it performed."""
    with _OpCount() as counter:
        out = fn()
    return out, counter.ops


def count_ops(fn):
    return counted(fn)[1]


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
    """(bound_ms, bound_by, bytes): the least time for the work, its
    operations at the peak of ``itemsize``'s type; the per-knot tables, read
    once for the whole batch, add ``table_bytes``."""
    nbytes = (n_in + n_out) * B * itemsize + n_flags * B + table_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (F64_OPS_PER_S if itemsize == 8 else F32_OPS_PER_S)
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
                lib.aslr_riccati_box_smem(int(ndx), int(nu), int(kind == "boxfddp"), size))
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


def kernel_cases(dtype, B=None, arms=("vsa", "sea"), T=None, box_ub=None):
    """{row: (kernel call, plain call, io_values kwargs, name, ndx, nu)} at
    the paths' shapes (T=100, B=4096 unless given). Arms: the 2-DoF VSA and
    SEA arms, and the 3- and 7-DoF SEA arms (sea3, sea7). ``box_ub`` ([nu])
    replaces the VSA box's upper bound (a homotopy stage's box)."""
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
            ub = torch.as_tensor(spec.ub if box_ub is None else box_ub, dtype=dtype,
                                 device="cuda")[:, None].expand(nu, B)
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
            cases[f"rollout2[{arm} gaps]"] = (partial(vk.rollout2, *roll_args),
                                              partial(vk.rollout2_plain, *roll_args),
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

    counts = {}     # each case's operations, counted on its f64 plain call (as in f32)
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, None)):
        tag = "f64" if dtype == torch.float64 else "f32"
        for label, (kern, plain, io_kw, name, ndx, nu) in kernel_cases(dtype).items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            if tag == "f64":
                want, counts[label] = counted(plain)
            else:
                want, plain_ms = timed_once(plain)
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
                target["plain_ms"] = plain_ms
                # K6's plain version runs K3's two trials at one step
                # length and keeps the first: half its operations are K6's
                n_ops = counts[label] // (2 if name == "rollout1" else 1)
                n_in, n_out, n_flags = io_values(name, T_PATH, ndx, nu, **io_kw)
                target["bound_ms"], target["bound_by"], nbytes = bound(
                    n_ops, n_in, n_out, n_flags, B_PATH, 4)
                target["ops"], target["bytes"] = n_ops, nbytes
                log(f"  {label} f32 time: kernel {target['ms']:.4f} ms, plain "
                    f"{target['plain_ms']:.4f} ms (the call compared), bound "
                    f"{target['bound_ms']:.4f} ms ({target['bound_by']}: {nbytes} bytes, "
                    f"{n_ops} ops)")
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


@phase("stage-box kernels")
def stage_box_kernels_phase(report):
    """K2 and K3 at the homotopy's capped stage boxes (the stiffness at most
    3, the first stage's; at most 1, the rescue's), T=100, B=4096: equal to
    their plain versions to the bit in f64 and f32, timed in f32, with the
    bound and the share of K3's trial controls on the capped bound."""
    from aslr_to_tpu_torch import rescue_continuation, stiffness_continuation
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import B_PATH, T_PATH

    ops = {}    # each row's operations, counted on its f64 plain call (as in f32)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        w = two_dof_vsa_boxddp(T=T_PATH, dtype=dtype)
        caps = dict(cap3=stiffness_continuation(w.problem, w.bounds)[1][0],
                    cap1=rescue_continuation(w.problem, w.bounds)[1][0])
        for cap, box_ub in caps.items():
            cases = kernel_cases(dtype, arms=("vsa",), box_ub=box_ub)
            for label, row in (("riccati_box[vsa]", f"riccati_box:{cap}"),
                               ("rollout2[vsa box]", f"rollout2:{cap}")):
                kern, plain, io_kw, name, ndx, nu = cases[label]
                before = build.LAUNCHES[name]
                if tag == "f64":
                    want, ops[row] = counted(plain)
                else:
                    want, plain_ms = timed_once(plain)
                err = check_at_batch(f"{row} (ub {box_ub.tolist()})", tag, kern, plain, B_PATH,
                                     want=want)
                del want
                if build.LAUNCHES[name] != before + 1:
                    raise AssertionError(f"{row}: the wrapper did not launch its kernel")
                if name == "rollout2":
                    on_cap = (kern()[0].us[:, 2:] == box_ub[2:, None]).double().mean()
                    log(f"  {row} {tag}: share of trial 0's stiffness controls on the cap "
                        f"{float(on_cap):.4f}")
                target = report[row]
                target["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
                if tag == "f32":
                    target["ms"] = cuda_ms(kern, 20)
                    target["plain_ms"] = plain_ms
                    n_in, n_out, n_flags = io_values(name, T_PATH, ndx, nu, **io_kw)
                    target["bound_ms"], target["bound_by"], nbytes = bound(
                        ops[row], n_in, n_out, n_flags, B_PATH, 4)
                    target["ops"], target["bytes"] = ops[row], nbytes
                    log(f"  {row} f32 time: kernel {target['ms']:.4f} ms, plain "
                        f"{target['plain_ms']:.4f} ms (the call compared), bound "
                        f"{target['bound_ms']:.4f} ms ({target['bound_by']}: {nbytes} bytes, "
                        f"{ops[row]} ops)")


@phase("n-DoF kernels")
def ndof_kernels_phase(report):
    """K1, K4, K3 and K6 at the 3- and 7-DoF SEA arms' instances, at the
    7-DoF path's shape (T=100, B_NDOF): to the bit against their plain
    versions in f64 and f32 (K6 also against K3's first trial), and in f32
    the kernel's time, the plain version's time (the call that was
    compared), its operations and the bound; then the kernel's time and
    bound at 4 B_NDOF, where a worker holds K3 at nl 7, whose layout the
    batch picks, to the bit again (nl7_rollouts_check). The
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

    ops = {}    # each case's operations, counted on its f64 plain call (as in f32)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases = kernel_cases(dtype, B_NDOF, ("sea3", "sea7"), T=T_PATH)
        for label, (kern, plain, io_kw, name, ndx, nu) in cases.items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            if tag == "f64":
                want, ops[label] = counted(plain)
            else:
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
            t["ops"] = ops[label] // (2 if name == "rollout1" else 1)
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
    # layout the batch picks, is held to the bit there by a worker
    # (nl7_rollouts_check, with K6)
    B = 4 * B_NDOF
    for label, (kern, _, io_kw, name, ndx, nu) in kernel_cases(
            torch.float32, B, ("sea3", "sea7"), T=T_PATH).items():
        t = report[f"{name}_n7"].setdefault("variants", {}).setdefault(f"{label} B={B}", {})
        t["ms"] = cuda_ms(kern, 10)
        ops = target(label, name)["ops"] * (B // B_NDOF)
        t["bound_ms"], t["bound_by"], nbytes = bound(
            ops, *io_values(name, T_PATH, ndx, nu, **io_kw), B, 4)
        log(f"  {label} f32 T={T_PATH} B={B}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes} bytes, {ops} ops)")


def check_at_batch(label, tag, kern, plain, B, want=None):
    """The kernel's outputs equal to its plain version's (``want``, or a
    call of ``plain``) to the bit at batch B (raises otherwise); returns the
    max abs error, 0."""
    from aslr_to_tpu_torch.measure import T_PATH

    got = kern()
    torch.cuda.synchronize()
    if want is None:
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


# the scenarios of a blown-up batch at nl 7 (nl7_rollout_cases): b mod 64 =
# 3 NaN gains, 4 the first link angle of x0 past sinf's and cosf's fast
# range reduction (105,615 rad), 5 the second link angle at -inf
BLOWN_UP = dict(nan=3, beyond=4, inf=5)
BEYOND_FAST_RANGE = 2e5


def nl7_target(spec, T, dtype):
    """``spec`` of the 7-DoF arm with a target a knot (knot t's goal turned by
    0.1 + 0.05 t about a tilted axis, its position on an arc; the terminal
    target kept) and its [T, 12] table on the card: the rollouts' table
    instance at nl 7."""
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk

    a = np.array([0.3, -0.2, 1.0]) / np.linalg.norm([0.3, -0.2, 1.0])
    Kx = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    rot = np.stack([np.eye(3) + np.sin(0.1 + 0.05 * t) * Kx
                    + (1.0 - np.cos(0.1 + 0.05 * t)) * Kx @ Kx for t in range(T)])
    pos = np.stack([[0.01, 0.05 + 0.003 * t, 0.18 - 0.001 * t] for t in range(T)])
    term_rinv, term_pos = vk._term_target(spec)
    pk = spec._replace(target_rot_inv=np.swapaxes(rot, 1, 2), target_pos=pos,
                       term_target_rot_inv=np.asarray(term_rinv),
                       term_target_pos=np.asarray(term_pos))
    return pk, torch.as_tensor(pk.target_table(T, dtype), device="cuda")


def nl7_rollout_cases(dtype, B, blown_up=False):
    """{instance: K3's arguments} at nl 7, T=100, batch B, in every instance:
    "sea" (DDP's, K4's gains) and "sea box gaps" (BoxFDDP's, K5's gains in
    the sevendof_box path's box) from ndof_box_cases, "sea gaps" (FDDP's)
    from kernel_cases, and "sea gaps target table" (its table instance, a
    target a knot, nl7_target); with ``blown_up``, the scenarios of
    BLOWN_UP changed in each."""
    from aslr_to_tpu_torch.measure import T_PATH

    cases = {}
    for label, case in list(kernel_cases(dtype, B, ("sea7",), T=T_PATH).items()) + list(
            ndof_box_cases(dtype, B, ("sea7",)).items()):
        m = re.fullmatch(r"rollout2\[sea7( gaps| box gaps|)\]", label)
        if m:
            cases["sea" + m.group(1)] = list(case[0].args)
    spec, tgt = nl7_target(cases["sea gaps"][0], T_PATH, dtype)
    cases["sea gaps target table"] = [spec] + cases["sea gaps"][1:] + [tgt]
    if blown_up:
        lane = torch.arange(B, device="cuda") % 64
        for args in cases.values():
            k, K, x0 = (a.clone() for a in args[3:6])
            k[..., lane == BLOWN_UP["nan"]] = float("nan")
            K[..., lane == BLOWN_UP["nan"]] = float("nan")
            x0[0, lane == BLOWN_UP["beyond"]] = BEYOND_FAST_RANGE
            x0[1, lane == BLOWN_UP["inf"]] = -float("inf")
            args[3:6] = [k, K, x0]
    return cases


def nl7_rollouts_check(batches, blown_up, only=None, tags=("f64", "f32")):
    """A worker's: K3 and K6 at nl 7 in every instance (nl7_rollout_cases) at
    each batch of ``batches``, T=100, in f64 and f32 (``tags``: those
    alone), to the bit against
    their plain versions (K6 at K3's second step length against the plain
    version's second trial); with ``blown_up``, on the batch with
    BLOWN_UP's scenarios, which must blow up as made; ``only``: that
    instance alone. K3's batch rule takes its wide layout at B_NDOF and its
    general one at 4 B_NDOF. The plain version runs with its queue kept
    short (_ShortQueue) and each kernel is waited for, so that a stopped
    worker leaves little to run in a phase's timing."""
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk
    from aslr_to_tpu_torch.measure import T_PATH

    for B in batches:
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            if tag not in tags:
                continue
            cases = nl7_rollout_cases(dtype, B, blown_up)
            for label, args in cases.items():
                if only is not None and label != only:
                    continue
                with _ShortQueue():
                    want = vk.rollout2_plain(*args)
                torch.cuda.synchronize()
                got = vk.rollout2(*args)
                torch.cuda.synchronize()
                one = vk.rollout1(*args[:6], *args[7:])
                torch.cuda.synchronize()
                pairs = [(f"K3 trial {i} {f}", g, w) for i in range(2)
                         for f, g, w in zip(want[i]._fields, got[i], want[i])]
                pairs += [(f"K6 {f}", g, w) for f, g, w in zip(want[1]._fields, one, want[1])]
                differ = [name for name, g, w in pairs if not same_bits(g, w)]
                if differ:
                    raise AssertionError(f"nl 7 {label} {tag} B={B}: {differ} differ from the "
                                         f"plain version")
                blown = ""
                if blown_up:
                    lane = torch.arange(B, device="cuda") % 64
                    cost = got[0].cost
                    q = got[0].xs[:, :7]
                    if not (bool(cost[lane == BLOWN_UP["nan"]].isnan().all())
                            and not bool(torch.isfinite(cost[lane == BLOWN_UP["inf"]]).any())
                            and bool((q[0, 0, lane == BLOWN_UP["beyond"]].abs()
                                      > 105615.0).all())):
                        raise AssertionError(f"nl 7 {label} {tag} B={B}: the blown-up "
                                             f"scenarios did not blow up as made")
                    finite = torch.isfinite(q)
                    blown = (f"; first trial's link angles not finite "
                             f"{100 * float((~finite).double().mean()):.2f}%, finite beyond "
                             f"105,615 rad {100 * float((finite & (q.abs() > 105615.0)).double().mean()):.2f}%")
                log(f"  nl 7 {label} {tag} T={T_PATH} B={B}{' blown up' if blown_up else ''}: "
                    f"K3 and K6 equal to the plain version to the bit{blown}")
                del want, got, one
            del cases
            torch.cuda.empty_cache()


def timed_once(fn):
    """``fn()`` and the milliseconds of that one call, by CUDA events."""
    with quiet():
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


def ndof_box_cases(dtype, B, arms=("sea3", "sea7")):
    """{row: (kernel call, plain call, io_values kwargs, name, ndx, nu)}: K5
    and the rollouts' DDP ("sea") and BoxFDDP ("sea box gaps") variants on
    the 3- and 7-DoF SEA arms at T=100, batch B, from kernel_cases' states
    and quasi-static controls: K5 warm (kprev 0, 2 QP iterations) in the box
    of the sevendof_box path (nl 7) or BOX_SEA3 (nl 3), which those controls
    cross, on the FDDP gaps; K3 and K6 "sea" on K4's gains (its plain
    version), "sea box gaps" on K5's in the same box, with gaps, feasible
    and infeasible lanes."""
    from aslr_to_tpu_torch import seven_dof_sea, three_dof_sea
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels import vsa_kernels as vk
    from aslr_to_tpu_torch.measure import SEVENDOF_BOX, T_PATH, x0_batch

    T = T_PATH
    cases = {}
    for arm in arms:
        w = (three_dof_sea if arm == "sea3" else seven_dof_sea)(T=T, dtype=dtype)
        spec = vk.extract_vsa_spec(w.problem, None)
        nu, ndx = spec.nu, spec.ndx
        x0 = x0_batch(B, dtype, seed=0, nx=ndx).T.contiguous()
        xs = x0.expand(T + 1, ndx, B).contiguous()
        us = w.problem.quasi_static(xs[:-1].permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device="cuda")
        lin = vk.linearize_plain(spec, xs, us, wterm)
        r = lin.run
        derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                  lin.term["Lx"], lin.term["Lxx"])
        fs = torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)
        reg = torch.full((B,), REG, dtype=dtype, device="cuda")
        if dtype == torch.float64:
            reg[::512] = -5.0
        ones = torch.ones(B, dtype=dtype, device="cuda")
        top = torch.tensor(SEVENDOF_BOX if arm == "sea7" else BOX_SEA3, dtype=dtype,
                           device="cuda")[:, None].expand(nu, B)
        lb, ub = (-top).contiguous(), top.contiguous()
        kprev = torch.zeros(T, nu, B, dtype=dtype, device="cuda")
        bf_args = derivs + (fs, us, kprev, lb, ub, reg, 2)
        cases[f"riccati_boxfddp[{arm} box]"] = (
            partial(rk.riccati_boxfddp_backward, *bf_args),
            partial(rk.riccati_boxfddp_plain, *bf_args),
            dict(boxed=True, warm=True), "riccati_boxfddp", ndx, nu)
        infeas = (torch.arange(B, device="cuda") % 2).to(dtype)
        gains = {}
        for variant, bw in (("", rk.riccati_fddp_plain(*derivs, fs, reg)),
                            (" box gaps", rk.riccati_boxfddp_plain(*bf_args))):
            gains[variant] = (torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0))
        for variant, tail, io in (("", (None, None), {}),
                                  (" box gaps", (lb, ub, fs, infeas), dict(boxed=True, gaps=True))):
            args = (spec, xs, us, *gains[variant], x0, ones, 0.5 * ones, wterm) + tail
            if not variant:
                args = args + (None, None)
            cases[f"rollout2[{arm}{variant}]"] = (partial(vk.rollout2, *args),
                                                  partial(vk.rollout2_plain, *args), io,
                                                  "rollout2", ndx, nu)
            r1 = args[:6] + args[7:]
            cases[f"rollout1[{arm}{variant}]"] = (partial(vk.rollout1, *r1),
                                                  partial(vk.rollout1_plain, *r1), io,
                                                  "rollout1", ndx, nu)
    return cases


def box_binds(label, name, args, got):
    """The share of K5's QP solutions (knot, control) that end on a bound of
    the box, or of K3's first trial's controls (K6's) that the clip puts on
    one; raises where it is 0 (the case would not exercise the box)."""
    if name == "riccati_boxfddp":
        us, lb, ub = args[10], args[12][None], args[13][None]
        on = (-got.k == lb - us) | (-got.k == ub - us)
    else:
        # K3's box follows its two step lengths, K6's its one
        at = 9 if name == "rollout2" else 8
        lb, ub = args[at][None], args[at + 1][None]
        trial = got[0] if name == "rollout2" else got
        on = (trial.us == lb) | (trial.us == ub)
    share = float(on.double().mean())
    if not share > 0:
        raise AssertionError(f"{label}: the box binds nowhere on these inputs")
    return share


def k5_iterate(dtype, B):
    """K5's inputs at (28, 7) in the last backward of NDOF_ITERATE_PASSES
    passes of the sevendof_box lane solve (B lanes, through the kernels), a
    solver iterate's: the lane solver's K5 wrapper recorded while it runs."""
    from aslr_to_tpu_torch.kernels import lane_solver
    from aslr_to_tpu_torch.measure import SEEDS, sevendof_solver, x0_batch

    seen = []
    wrapper = lane_solver.riccati_boxfddp_backward

    def record(*args, **kwargs):
        seen[:] = [(args, kwargs)]
        return wrapper(*args, **kwargs)

    lane_solver.riccati_boxfddp_backward = record
    try:
        solve = sevendof_solver("sevendof_box", dtype=dtype, maxiter=NDOF_ITERATE_PASSES)
        solve(x0_batch(B, dtype, SEEDS["sevendof_box"], nx=28))
    finally:
        lane_solver.riccati_boxfddp_backward = wrapper
    torch.cuda.synchronize()
    args, kwargs = seen[0]
    if kwargs.get("per_knot_box"):
        raise AssertionError("the sevendof_box solve gave K5 box tables")
    return args


@phase("n-DoF box kernels")
def ndof_box_kernels_phase(report):
    """K5 at (12, 3) and (28, 7) and the rollouts' DDP and BoxFDDP variants
    at nl 3 and 7 (ndof_box_cases): first the launch of each 7-DoF instance
    (K5 at (28, 7); K6 and K3, K3 in the layout its batch picks) at B_NDOF
    and 4 B_NDOF in f32 and f64 with its ptxas line; then, at T=100,
    B_NDOF, each against its plain version to the bit in f64 and f32 (K6
    also against K3's first trial), with the share of the box that binds,
    and in f32 the kernel's time, the plain version's (the call that was
    compared), its operations and the bound; K5 also on a solver iterate's
    inputs (k5_iterate) to the bit in f64 and f32, timed in f32; then at 4
    B_NDOF every new instance timed (a worker holds K3 at nl 7 to the bit
    there, nl7_rollouts_check: its batch rule picks the general layout). K5 at (28, 7) is the row ``riccati_boxfddp_n7``, the rest
    variants of it and of ``rollout2_n7`` and ``rollout1_n7``."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.measure import T_PATH

    def target(label, name):
        if label == "riccati_boxfddp[sea7 box]":
            return report["riccati_boxfddp_n7"]
        return report[f"{name}_n7"].setdefault("variants", {}).setdefault(label, {})

    ptxas = kernel_ptxas(build.build_log, build.lib())
    for name, variant, prefix in (("riccati_boxfddp", None, "K5 {} (ndx 28, nu 7,"),
                                  ("rollout1", "sea", "K6 {} nl 7 SEA:"),
                                  ("rollout1", "sea box gaps", "K6 {} nl 7 SEA box gaps:"),
                                  ("rollout2", "sea", "K3 {} nl 7 SEA {}:"),
                                  ("rollout2", "sea box gaps", "K3 {} nl 7 SEA box gaps {}:")):
        key = f"{name}_n7" if variant is None else f"{name}[sea7{variant[3:]}]"
        row = target(key if variant else "riccati_boxfddp[sea7 box]", name)
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            for B in (B_NDOF, 4 * B_NDOF):
                kw = {} if variant is None else dict(variant=variant)
                info = build.launch_of(name, dtype, B, T=T_PATH, **kw)
                layout = f", the {info['layout']} layout" if "layout" in info else ""
                log(f"  {key} {tag} B={B}: grid {info['grid']}, {info['threads']} threads a "
                    f"block, {info['smem']} bytes of dynamic shared memory, "
                    f"{info['blocks_per_sm']} blocks resident an SM{layout}")
                row.setdefault("launch", {})[f"{tag} B={B}"] = info
                line = [x for x in ptxas if x.startswith(prefix.format(tag, info.get("layout")))]
                if len(line) != 1:
                    raise AssertionError(f"{key} {tag}: no single ptxas line in {ptxas}")
                row.setdefault("ptxas", {})[f"{tag} B={B}"] = line[0]
                if B == B_NDOF or "layout" in info:
                    log(f"  {key} {tag} B={B} ptxas: {line[0]}")

    ops = {}    # each case's operations, counted on its f64 plain call (as in f32)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases = ndof_box_cases(dtype, B_NDOF)
        for label, (kern, plain, io_kw, name, ndx, nu) in cases.items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            if tag == "f64":
                want, ops[label] = counted(plain)
            else:
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
            t = target(label, name)
            binds = ""
            if io_kw.get("boxed"):
                t[f"on_bound_{tag}"] = box_binds(label, name, kern.args, got)
                binds = f"; on a bound: {100 * t[f'on_bound_{tag}']:.2f}%"
            del got, want, want_f
            log(f"  {label} {tag} T={T_PATH} B={B_NDOF}: equal to the plain version to the bit "
                f"(max abs err {err:.3e}){binds}")
            t["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            if tag == "f64" and label == "riccati_boxfddp[sea7 box]":
                # K5 at (28, 7), whose f64 registers its design answers: its f64 time too
                t["ms_f64"] = cuda_ms(kern, 10)
                t["bound_ms_f64"], by, nbytes = bound(
                    ops[label], *io_values(name, T_PATH, ndx, nu, **io_kw), B_NDOF, 8)
                log(f"  {label} f64 T={T_PATH} B={B_NDOF}: kernel {t['ms_f64']:.4f} ms, bound "
                    f"{t['bound_ms_f64']:.4f} ms ({by}: {nbytes} bytes, {ops[label]} ops)")
            if tag == "f64":
                continue
            t["ms"], t["plain_ms"] = cuda_ms(kern, 10), plain_ms
            t["ops"] = ops[label] // (2 if name == "rollout1" else 1)
            n_in, n_out, n_flags = io_values(name, T_PATH, ndx, nu, **io_kw)
            t["bound_ms"], t["bound_by"], nbytes = bound(t["ops"], n_in, n_out, n_flags,
                                                         B_NDOF, 4)
            t["bytes"] = nbytes
            log(f"  {label} f32 T={T_PATH} B={B_NDOF}: kernel {t['ms']:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                f"{nbytes} bytes, {t['ops']} ops)")
        del cases
        # K5 on a solver iterate's inputs
        args = k5_iterate(dtype, B_NDOF)
        label = f"riccati_boxfddp[sea7 box] iterate (pass {NDOF_ITERATE_PASSES})"
        kern = partial(rk.riccati_boxfddp_backward, *args)
        t = target(label, "riccati_boxfddp")
        t[f"max_abs_err_{tag}"] = check_at_batch(label, tag, kern,
                                                 partial(rk.riccati_boxfddp_plain, *args), B_NDOF)
        got = kern()
        t[f"on_bound_{tag}"] = box_binds(label, "riccati_boxfddp", args, got)
        t[f"ok_lanes_{tag}"] = int(got.ok.sum())
        log(f"  {label} {tag}: on a bound {100 * t[f'on_bound_{tag}']:.2f}%, ok on "
            f"{t[f'ok_lanes_{tag}']} of {B_NDOF} lanes")
        if tag == "f32":
            t["ms"] = cuda_ms(kern, 10)
            log(f"  {label} f32: kernel {t['ms']:.4f} ms")
        del args, kern, got
    # four times the batch, where K3 at nl 7 takes the general layout (a
    # worker holds it to the bit there, nl7_rollouts_check): every new instance
    # timed
    B = 4 * B_NDOF
    for label, (kern, plain, io_kw, name, ndx, nu) in ndof_box_cases(torch.float32, B).items():
        row = "riccati_boxfddp_n7" if name == "riccati_boxfddp" else f"{name}_n7"
        t = report[row].setdefault("variants", {}).setdefault(f"{label} B={B}", {})
        t["ms"] = cuda_ms(kern, 10)
        ops = target(label, name)["ops"] * (B // B_NDOF)
        t["bound_ms"], t["bound_by"], nbytes = bound(
            ops, *io_values(name, T_PATH, ndx, nu, **io_kw), B, 4)
        log(f"  {label} f32 T={T_PATH} B={B}: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes} bytes, {ops} ops)")


@phase("probe")
def probe_phase(report):
    """P in every configuration against its plain version (raises on a
    difference), driven with the launch counters reset just before."""
    from aslr_to_tpu_torch import probe
    from aslr_to_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    with quiet():       # probe.run times each configuration
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

    with quiet():
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
        if row in STAGE_ROWS:       # counted by stage (homotopy_phase)
            continue
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


def solve_path(name, report, card, expect, nu, n_timed, tpu=None, nx=8, first=False):
    """Drive the path ``name`` of measure.py at T=100 and its batch (4096,
    or 1024 for the 7-DoF paths), f32: its set-up (the SEA cold solve)
    where it has one, or with ``first`` a first solve, untimed, then
    ``n_timed`` solves. Returns the convergence summaries, the set-up's (or
    None) and the last solve's, and the last solve's result."""
    from aslr_to_tpu_torch.measure import build_path, path_batch, path_T

    p, B, T = build_path(name), path_batch(name), path_T(name)
    prep = setup_summ = None
    if first:
        _, t = drive(name, report, lambda: p.solve(*p.args(0, None)), expect)
        log(f"  first solve: {t:.4f} s")
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
        recorded = (f"; before the nl 7 rollouts' redesign {RECORDED_SOLVES_PER_S[name]}"
                    if name in RECORDED_SOLVES_PER_S else "")
        log(f"  solve {i}: {t:.4f} s, {B / t:.2f} solves/s on {card} "
            f"(T={T}, B={B}, f32, maxiter={p.maxiter}){recorded}")
    return setup_summ, summarize(res, B, T, nu, f"{name}, last solve, f32", tpu, nx), res


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


def on_bound(res, bounds):
    """The share of the final controls that sit on a bound of the box: of
    every lane's, and of the lanes that did not diverge (None if none)."""
    on = (res.us == bounds.lb) | (res.us == bounds.ub)
    live = ~res.diverged
    return (float(on.double().mean()),
            float(on[live].double().mean()) if bool(live.any()) else None)


@phase("7-DoF box and DDP")
def sevendof_box_phase(report, card):
    """The 7-DoF reach under the torque box (measure.py paths sevendof_box
    and fast_sevendof_box: BoxFDDP, K1, K5 at (28, 7), K3 or K6 at nl 7 with
    the box and gaps) and as DDP (sevendof_ddp: K1, K4 at (28, 7) with zero
    gaps, K3 without box or gaps), B=1024, T=100, f32: a first solve, then
    two timed ones each, with solves/s and the convergence accounting; the
    share of the final controls on a bound (it must be above 0, or K5's QP
    ran unclamped); the fast route's statistics beside the lane route's
    (not gated: at T=100 this solve is chaotic, and two routes that sum in
    other orders end its lanes apart); the fast DDP route once (K1, the
    generic backward, K6 without box or gaps), within 3 points of its lane
    route. Each launch count is of the last solve; the variants' rows take
    theirs from their paths."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import sevendof_bounds

    bounds = sevendof_bounds(torch.float32)
    summ = {}
    for name, expect, variant in (
            ("sevendof_box", ("linearize", "riccati_boxfddp", "rollout2"),
             "rollout2[sea7 box gaps]"),
            ("fast_sevendof_box", ("linearize", "riccati_boxfddp", "rollout1"),
             "rollout1[sea7 box gaps]"),
            ("sevendof_ddp", ("linearize", "riccati_fddp", "rollout2"), "rollout2[sea7]")):
        _, summ[name], res = solve_path(name, report, card, expect, 7, 2, nx=28, first=True)
        kernel = variant.split("[")[0]
        report[f"{kernel}_n7"]["variants"][variant]["launches"] = build.LAUNCHES[kernel]
        if name.endswith("_box"):
            share, live = on_bound(res, bounds)
            summ[name].update(on_bound=share, on_bound_live=live)
            log(f"  {name}: final controls on a bound of the box: {100 * share:.4f}% of all "
                f"lanes', " + ("no lane left that did not diverge" if live is None else
                               f"{100 * live:.4f}% of the lanes that did not diverge"))
            if not share > 0:
                raise AssertionError(f"{name}: no final control on a bound of the box")
        del res
    for key in ("converged_frac", "diverged_frac", "mean_iterations", "median_cost",
                "on_bound"):
        log(f"  BoxFDDP at T=100, fast route beside the lane route (not gated): {key} "
            f"{summ['fast_sevendof_box'][key]} / {summ['sevendof_box'][key]}")
    _, fast_ddp, _ = solve_path("fast_sevendof_ddp", report, card, ("linearize", "rollout1"), 7,
                                1, nx=28)
    report["rollout1_n7"]["variants"]["rollout1[sea7]"]["launches"] = build.LAUNCHES["rollout1"]
    close_to_lanes("fast 7-DoF DDP", fast_ddp, summ["sevendof_ddp"])
    report["riccati_boxfddp_n7"].setdefault("paths", {}).update(summ)


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


def stage_launches(stats, part, stages, kernel):
    """The launches of ``kernel`` in the stages ``stages`` of the homotopy's
    ``part`` ("main" or "rescue"), from the launch counts its solve kept
    after each stage (``build_lane_homotopy``'s ``stats``)."""
    total, prev = 0, 0
    for p, i, counts in stats["launches"]:
        if p == part and i in stages:
            total += counts[kernel] - prev
        prev = counts[kernel]
    return total


@phase("homotopy")
def homotopy_phase(report, card):
    """The staged homotopy with the rescue on the lane route (K1, K2, K3),
    its main pass and rescue timed apart; then the fast route's homotopy
    (K1, K2, K6) against the lane route's on the same inputs with the same
    scales and no stage boxes."""
    from aslr_to_tpu_torch.measure import RESCUE_SIZE, build_path

    name, B, T, expect = "homotopy", 4096, 100, ("linearize", "riccati_box", "rollout2")
    p = build_path(name)
    prep, t = drive(name, report, p.setup, expect)
    log(f"  first solve: {t:.4f} s")
    for i in range(2):
        inputs = p.args(i, prep)
        res, t = drive(name, report, lambda: p.solve(*inputs), expect)
        st = p.solve.stats
        log(f"  solve {i}: {t:.4f} s, {B / t:.2f} solves/s on {card} (T={T}, B={B}, f32, "
            f"maxiter={p.maxiter} a stage, rescue_size={RESCUE_SIZE}); main pass "
            f"{st['main_s']:.4f} s, rescue {st['rescue_s']:.4f} s; lanes diverged after the "
            f"main pass {int(st['main_diverged'])}, rescued {int(st['rescued'])}")
    for row, cap in STAGE_ROWS.items():
        part, stages = CAP_STAGES[cap]
        kernel = ROW_KERNEL[row]
        report[row]["launches"] = stage_launches(st, part, stages, kernel)
        report[row]["launches_by_path"] = {name: report[row]["launches"]}
        if report[row]["launches"] <= 0:
            raise AssertionError(f"{row}: no launch in the stages at {cap}")
    log("  launches a stage (K1, K2, K3): " + "; ".join(
        f"{part} {i}: {tuple(c[k] for k in expect)}" for part, i, c in st["launches"]))
    summ = summarize(res, B, T, 4, f"{name}, last solve, f32")
    tpu = TPU_REFERENCE[name]
    log(f"  quality against the TPU's (BENCH_r05, f32, B=4096, a cross-check of "
        f"convergence only): median cost {summ['median_cost']} (TPU {tpu['median_cost']}, "
        f"{100 * (summ['median_cost'] / tpu['median_cost'] - 1):+.2f}%), diverged "
        f"{summ['diverged_frac']} (TPU {tpu['diverged_frac']}, "
        f"{100 * (summ['diverged_frac'] - tpu['diverged_frac']):+.2f} points)")
    got = {}
    for path, kern in (("homotopy_scales", "rollout2"), ("fast_homotopy", "rollout1")):
        q = build_path(path)
        out, t = drive(path, report, q.setup, ("linearize", "riccati_box", kern))
        log(f"  {path} on the homotopy's inputs: {t:.4f} s, {B / t:.2f} solves/s")
        got[path] = summarize(out, B, T, 4, f"{path}, f32")
    close_to_lanes("fast homotopy (scales only)", got["fast_homotopy"], got["homotopy_scales"])


def first_parting(a, b, rtol=1e-8):
    """The first index where two per-iteration series part beyond rtol
    (NaN past a solve's last iteration on both), or None."""
    part = ((a - b).abs() > rtol * b.abs()) | (a.isnan() != b.isnan())
    idx = torch.nonzero(part).flatten()
    return int(idx[0]) if idx.numel() else None


def lanes_equal(label, a, b, B, x0s, explain=None):
    """At least B - 1 lanes agree: equal iterations and flags, and cost
    within rtol 1e-8 unless the lane diverged in both (a diverged lane's
    cost is that of a blown-up rollout, chaotic in the last bit). Each lane
    that does not agree is printed with its x0 and the first iteration at
    which the two routes' per-iteration logs part; returns {lane: that
    iteration} for the lanes whose logs part. ``explain(lane, iteration)``,
    where given, is asked about each such lane, and a lane it explains
    (returns a true value) counts with the lanes that agree."""
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
    if explain is not None:
        explained = [lane for lane, j in parted.items() if explain(lane, j)]
        log(f"  {label}: {len(explained)} of the {B - n_agree} lanes that part explained "
            f"({explained})")
        n_agree += len(explained)
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
    """One timed f32 solve of the generic, fast and lane routes on the card
    (the T=30 golden through SolverBoxDDP is the golden check's)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_PATH, summary, x0_batch

    # the main path's settings but MAXITER_TIMED iterations: the generic
    # route runs thousands of small kernels a knot loop
    w = two_dof_vsa_boxddp(T=T_PATH, dtype=torch.float32)
    x0s = x0_batch(B_TIMED, torch.float32, 0)
    timed = SolverSettings(maxiter=MAXITER_TIMED, th_stop=1e-5, boxqp_warm_iters=2)
    for route in (False, True, "lanes"):
        solve = make_batched_solver(w.problem, timed, use_gaps=False, bounds=w.bounds,
                                    use_fast_path=route)
        with quiet():
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
    backends_agree(label, res["auto"], res["plain"], B)


def backends_agree(label, k, p, B):
    """At least B - 1 lanes of the kernel backend's result ``k`` equal the
    plain backend's ``p`` in iterations and flags, with cost within rtol
    1e-8 in those lanes."""
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
    BoxDDP and SEA FDDP at B=256, T=40, maxiter 20, BoxFDDP in a tight box
    at B=128, T=40, maxiter 10."""
    from aslr_to_tpu_torch import SolverSettings, two_dof_sea, two_dof_vsa_boxddp

    f64 = torch.float64
    if label == "BoxDDP":
        w = two_dof_vsa_boxddp(T=T_PARITY, dtype=f64)
        parity(label, w, w.bounds, False, B_PARITY,
               SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2), seed=1)
    elif label == "SEA FDDP":
        parity(label, two_dof_sea(T=T_PARITY, dtype=f64), None, True, B_PARITY,
               SolverSettings(maxiter=20, th_stop=1e-5), seed=3)
    else:
        parity(label, two_dof_vsa_boxddp(T=T_PARITY_BOX, dtype=f64), tight_box(f64), True,
               B_PARITY_BOX, SolverSettings(maxiter=10, th_stop=1e-7), seed=4)


def ndof_parity_check(family, route, T=T_NDOF_PARITY):
    """A 7-DoF family (NDOF_FAMILIES: "BoxFDDP" in the sevendof_box paths'
    box, warm QPs of 2 iterations; "DDP") on the lane or the fast route in
    f64 through its kernels against the same route through their plain
    versions: B_NDOF_PARITY lanes (x0s of seed 8) at horizon T, maxiter 20,
    warm-started; at least B - 1 lanes equal in iterations and flags, cost
    within rtol 1e-8 (backends_agree), and the lanes equal to the bit
    counted (every kernel equals its plain version to the bit)."""
    from aslr_to_tpu_torch.measure import SEEDS, sevendof_solver, x0_batch

    name = NDOF_FAMILIES[family][route == "fast"]
    x0s = x0_batch(B_NDOF_PARITY, torch.float64, SEEDS[name], nx=28)
    res = {}
    for backend in ("auto", "plain"):
        solve = sevendof_solver(name, T, torch.float64, backend=backend,
                                maxiter=MAXITER_NDOF_PARITY)
        t0 = time.perf_counter()
        res[backend] = solve(x0s)
        torch.cuda.synchronize()
        log(f"  7-DoF {family} {route} f64 T={T} B={B_NDOF_PARITY} maxiter="
            f"{MAXITER_NDOF_PARITY} {backend} backend: {time.perf_counter() - t0:.3f} s")
    k, p = res["auto"], res["plain"]
    label = f"7-DoF {family} {route} T={T}"
    backends_agree(label, k, p, B_NDOF_PARITY)
    bits = torch.ones_like(k.converged)
    for a, b in ((k.xs, p.xs), (k.us, p.us), (k.cost, p.cost), (k.iterations, p.iterations)):
        a, b = a.double(), b.double()
        same = (a.isnan() == b.isnan()) & ((a == b) | a.isnan())
        bits = bits & same.reshape(B_NDOF_PARITY, -1).all(1)
    log(f"  {label}: {int(bits.sum())}/{B_NDOF_PARITY} lanes equal to the bit in xs, us, cost "
        f"and iterations; converged {float(k.converged.double().mean())} / "
        f"{float(p.converged.double().mean())}, diverged {float(k.diverged.double().mean())} / "
        f"{float(p.diverged.double().mean())} (kernels / plain)")


def bound_flips(a, b, bounds, rtol=1e-12):
    """(knot, control) where a control of iterate ``a`` sits on a bound of
    the box and the same control of ``b`` lies within ``rtol`` of that bound
    but inside it, or the other way round (one lane, ``us [1, T, nu]``)."""
    flips = []
    for x, y in ((a.us[0], b.us[0]), (b.us[0], a.us[0])):
        for bnd in (bounds.lb, bounds.ub):
            near = (x == bnd) & (y != bnd) & ((y - bnd).abs() <= rtol * bnd.abs())
            flips += [tuple(ti) for ti in torch.nonzero(near).tolist()]
    return sorted(set(flips))


def explain_box_parting(label, family, lane, x0, j):
    """A lane whose generic and kernel routes' logs part first at pass j:
    both routes re-run on its x0 for j and j + 1 passes; returns the
    controls that sit on a bound of the box in one route's iterate and one
    rounding inside it in the other's (bound_flips), printed, or []. Such a
    control is clamped by the next BoxQP of one route and free in the
    other's, a discrete choice that the solve then amplifies."""
    from aslr_to_tpu_torch.measure import sevendof_bounds, sevendof_solver

    lanes_name, _ = NDOF_FAMILIES[family]
    bounds = sevendof_bounds(torch.float64)
    for n in (j, j + 1):
        g, k = (sevendof_solver(lanes_name, T_NDOF_GENERIC, torch.float64, maxiter=n,
                                boxqp_warm_iters=0, use_fast_path=route)(x0)
                for route in (False, "lanes"))
        flips = bound_flips(g, k, bounds)
        if flips:
            log(f"    {label} lane {lane}: after {n} passes, controls on a bound in one route "
                f"and one rounding inside it in the other: " + ", ".join(
                    f"knot {t} control {i} (generic {float(g.us[0, t, i])!r}, lanes "
                    f"{float(k.us[0, t, i])!r})" for t, i in flips))
            return flips
    return []


def ndof_generic_check(family):
    """The lane and fast routes of a 7-DoF family against the generic route
    (the reference) in f64 at T=10, B=16, maxiter 20, warm-started, BoxFDDP
    in the sevendof_box paths' box with cold QPs (warm BoxQPs part the
    generic and kernel routes at 1e-6: the generic QP stops at convergence,
    the kernels' runs all its iterations). DDP: at least B - 1 lanes equal
    in iterations and flags, cost within rtol 1e-8 (lanes_equal). BoxFDDP:
    the fast route against the lane route so (the kernel routes share K5
    and the rollout's code), and each against the generic route so, a lane
    counting with those that agree where its per-iteration logs agree
    within rtol 1e-8 up to the pass at which they part and there a control
    sits on a bound of the box in one route and one rounding inside it in
    the other (explain_box_parting): the routes' feedback sums in other
    orders land on either side of the bound, the next BoxQP clamps the
    control in one route and frees it in the other, and the solve, which
    converges on no lane in 20 passes at T=10, amplifies that (PERF.md; on
    an H100 12 of these 16 lanes agreed in full)."""
    from aslr_to_tpu_torch.measure import SEEDS, sevendof_solver, x0_batch

    lanes_name, fast_name = NDOF_FAMILIES[family]
    B, T = B_NDOF_BOX_GENERIC, T_NDOF_GENERIC
    x0s = x0_batch(B, torch.float64, SEEDS[lanes_name], nx=28)
    res = {}
    for route, name in (("generic", lanes_name), ("lanes", lanes_name), ("fast", fast_name)):
        solve = sevendof_solver(name, T, torch.float64, maxiter=MAXITER_NDOF_BOX_GENERIC,
                                boxqp_warm_iters=0, keep_log=True,
                                use_fast_path=False if route == "generic" else None)
        t0 = time.perf_counter()
        res[route] = solve(x0s)
        torch.cuda.synchronize()
        log(f"  7-DoF {family} f64 T={T} B={B} maxiter={MAXITER_NDOF_BOX_GENERIC} {route} "
            f"route: {time.perf_counter() - t0:.3f} s; converged "
            f"{float(res[route].converged.double().mean())}, diverged "
            f"{float(res[route].diverged.double().mean())}")
    if family == "DDP":
        lanes_equal(f"7-DoF {family} lanes against generic", res["lanes"], res["generic"], B, x0s)
        lanes_equal(f"7-DoF {family} fast against generic", res["fast"], res["generic"], B, x0s)
        return
    lanes_equal(f"7-DoF {family} fast against lanes", res["fast"], res["lanes"], B, x0s)
    for route in ("lanes", "fast"):
        label = f"7-DoF {family} {route} against generic"
        lanes_equal(label, res[route], res["generic"], B, x0s,
                    explain=lambda lane, j: explain_box_parting(label, family, lane,
                                                                x0s[lane:lane + 1], j))


def homotopy_parity_check(part):
    """The homotopy with the rescue in f64 through the kernels against its
    plain backend, lane by lane: the production schedules at T=20, B=64,
    maxiter 10 a stage, rescue_size 16, lane INF_LANE at x0 = inf (it must
    stay diverged). Its two passes run in two workers, since the plain
    backend's 12 stages of small kernels took 243 s on the card alone and
    447 s beside the other workers in one process at T=40: ``part`` "main", the 5
    main stages on the 64 lanes; "rescue", the 7 rescue stages, cold, on
    the 16 lanes that the kernels' main pass picks (diverged first, by
    the stable sort of ``build_lane_homotopy``; the main part holds its
    flags to the plain backend's), and the kernels' homotopy with the
    rescue against those two passes of its own, to the bit."""
    from aslr_to_tpu_torch import (SolverSettings, make_batched_solver, rescue_continuation,
                                   stiffness_continuation, two_dof_vsa_boxddp)
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import SEEDS, homotopy_solver, x0_batch

    w = two_dof_vsa_boxddp(T=T_HOMOTOPY_PARITY, dtype=torch.float64)
    settings = SolverSettings(maxiter=MAXITER_HOMOTOPY_PARITY, th_stop=1e-5, boxqp_warm_iters=2)
    schedule = dict(main=stiffness_continuation(w.problem, w.bounds),
                    rescue=rescue_continuation(w.problem, w.bounds))

    def solver(stages, backend):
        return make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                   use_fast_path="lanes", globalization="homotopy",
                                   scales=schedule[stages][0], ub_stages=schedule[stages][1],
                                   backend=backend)

    x0s = x0_batch(B_HOMOTOPY_PARITY, torch.float64, SEEDS["homotopy"])
    x0s[INF_LANE, 0] = float("inf")
    kernel_main = solver("main", "auto")(x0s)
    inputs, inf_lane = x0s, INF_LANE
    if part == "rescue":
        idx = torch.argsort((~kernel_main.diverged).to(torch.int8),
                            stable=True)[:RESCUE_HOMOTOPY_PARITY]
        inputs, inf_lane = x0s[idx], int(torch.nonzero(idx == INF_LANE)[0, 0])
    res = {}
    for backend in ("auto", "plain"):
        build.reset_launches()
        t0 = time.perf_counter()
        res[backend] = solver(part, backend)(inputs)
        torch.cuda.synchronize()
        launched = sum(build.LAUNCHES.values())
        log(f"  homotopy {part} pass f64 T={T_HOMOTOPY_PARITY} B={inputs.shape[0]} {backend} "
            f"backend: {time.perf_counter() - t0:.3f} s, lanes diverged "
            f"{int(res[backend].diverged.sum())}, kernel launches {launched}")
        if (launched > 0) != (backend == "auto"):
            raise AssertionError(f"homotopy parity: the {backend} backend launched {launched}")
        if not bool(res[backend].diverged[inf_lane]):
            raise AssertionError("homotopy parity: the lane at x0 = inf did not diverge")
    backends_agree(f"homotopy {part} pass", res["auto"], res["plain"], inputs.shape[0])
    if part == "main":
        return
    # the kernels' homotopy with the rescue is its main pass with the picked
    # lanes that the main pass left diverged and the rescue did not replaced
    full = homotopy_solver("homotopy", T_HOMOTOPY_PARITY, torch.float64,
                           maxiter=MAXITER_HOMOTOPY_PARITY,
                           rescue_size=RESCUE_HOMOTOPY_PARITY)(x0s)
    rescue = res["auto"]
    take = kernel_main.diverged[idx] & ~rescue.diverged
    for f in ("xs", "us", "cost", "stop", "iterations", "converged", "diverged", "reg"):
        want = getattr(kernel_main, f).clone()
        want[idx[take]] = getattr(rescue, f)[take]
        if not same_bits(getattr(full, f).double(), want.double()):
            raise AssertionError(f"homotopy parity: the rescued solve's {f} is not the merge "
                                 f"of its two passes")
    log(f"  homotopy with the rescue through the kernels: the merge of its two passes to the "
        f"bit ({int(take.sum())} lanes taken from the rescue)")


def pendulum_k4_cases(dtype, B):
    """K4's inputs (lane tensors) from the double-pendulum path at T=10,
    batch B: {"cold": its cold start (xs = x0s, us = 0), "pass m": its
    iterate after m passes}, m the first of PENDULUM_PASSES at which Quu
    fails to factor on some lanes and factors on the others at the
    solver's reg (by the plain version; raises if none does)."""
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.kernels.vsa_kernels import to_lanes
    from aslr_to_tpu_torch.measure import T_PENDULUM, pendulum_solver, pendulum_x0s
    from aslr_to_tpu_torch.solvers import ddp

    T = T_PENDULUM
    w, _ = pendulum_solver(T, dtype)
    x0s = pendulum_x0s(w, B)
    p = dataclasses.replace(w.problem, x0=x0s)
    reg = torch.full((B,), REG, dtype=dtype, device="cuda")

    def inputs(xs, us):
        _, run, term, xnext, _ = ddp._linearize_core(p, xs, us)
        fs = ddp._gaps(p, xs, xnext)
        derivs = [to_lanes(getattr(run, n)) for n in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")]
        return tuple(derivs + [to_lanes(term.Lx), to_lanes(term.Lxx), to_lanes(fs), reg])

    cases = {"cold": inputs(x0s[:, None].expand(B, T + 1, x0s.shape[1]).contiguous(),
                            torch.zeros(B, T, 2, dtype=dtype, device="cuda"))}
    for m in PENDULUM_PASSES:
        res = pendulum_solver(T, dtype, maxiter=m)[1](x0s)
        args = inputs(res.xs, res.us)
        ok = rk.riccati_fddp_plain(*args).ok
        if bool(ok.any()) and not bool(ok.all()):
            cases[f"pass {m}"] = args
            return cases
    raise AssertionError(f"double pendulum: no pass of {PENDULUM_PASSES} leaves Quu failing to "
                         f"factor on some lanes only")


def zero_column_kept(out):
    """k[:, 1] and K[:, 1, :] exactly 0 on every lane whose sweep factored
    (the second control has no column in Fu, no weight in Luu)."""
    ok = out.ok
    return bool((out.k[:, 1][:, ok] == 0).all()) and bool((out.K[:, 1][..., ok] == 0).all())


@phase("pendulum kernels")
def pendulum_kernels_phase(report):
    """K4 at (8, 2) on the double pendulum's data (T=10, B=4096): its cold
    start and a mid-solve pass where Quu fails to factor on some lanes
    (``pendulum_k4_cases``), each to the bit against the plain version in
    f64 and f32, ok and retryable included; the data's zero Fu column and
    zero Luu[1, 1] and its indefinite terminal Lxx checked, and k[:, 1],
    K[:, 1, :] exactly 0 in both versions where a lane factors; timed in
    f32 at B=4096 and, on the inputs repeated four times, at 16384 (the
    device time by torch.profiler, since a T=10 launch is shorter than its
    wrapper's host time, and the CUDA events' beside), with the plain
    version's time and the bound. The row is the mid-solve pass's."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.measure import B_PATH, T_PENDULUM

    T, ndx, nu, B = T_PENDULUM, 8, 2, B_PATH
    row = report["riccati_fddp:pendulum"]
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for label, args in pendulum_k4_cases(dtype, B).items():
            Fu, Luu, tLxx = args[1], args[6], args[8]
            indef = float((torch.linalg.eigvalsh(tLxx.permute(2, 0, 1).double())[:, 0] < 0)
                          .double().mean())
            if not (bool((Fu[:, :, 1] == 0).all()) and bool((Luu[:, 1, 1] == 0).all())):
                raise AssertionError(f"K4 pendulum {label} {tag}: Fu's second column or "
                                     f"Luu[1, 1] is not zero")
            kern = partial(rk.riccati_fddp_backward, *args)
            plain = partial(rk.riccati_fddp_plain, *args)
            before = build.LAUNCHES["riccati_fddp"]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES["riccati_fddp"] != before + 1:
                raise AssertionError(f"K4 pendulum {label}: the wrapper did not launch its kernel")
            want = plain()
            _, err = compare(f"K4 pendulum {label}", got, want, None)
            want_f = flat(want)
            differ = [k for k, g in flat(got).items() if not same_bits(g, want_f[k])]
            if differ:
                raise AssertionError(f"K4 pendulum {label} {tag}: {differ} differ from the plain "
                                     f"version (max abs err {err:.3e}); the kernel is built to "
                                     f"equal it to the bit")
            if not (zero_column_kept(got) and zero_column_kept(want)):
                raise AssertionError(f"K4 pendulum {label} {tag}: k[:, 1] or K[:, 1] is not 0 "
                                     f"on a lane that factored")
            log(f"  K4 pendulum {label} {tag} T={T} B={B}: equal to the plain version to the bit, "
                f"ok and retryable included (ok on {int(got.ok.sum())}, retryable on "
                f"{int(got.retryable.sum())} of {B} lanes; terminal Lxx indefinite on "
                f"{100 * indef:.2f}% of them); k[:, 1] and K[:, 1] zero where a lane factors")
            target = row if label != "cold" else row.setdefault("variants", {}).setdefault(
                "cold start", {})
            target["case"] = label
            target["max_abs_err" if tag == "f64" else "max_abs_err_f32"] = err
            target[f"ok_lanes_{tag}"] = int(got.ok.sum())
            if tag == "f64":
                continue
            # at T=10 a launch is shorter than its wrapper's host time: the
            # kernel's device time by the profiler, the CUDA events' beside
            target["ms"] = device_ms(kern, 20, "riccati_fddp_kernel")
            target["events_ms"], target["plain_ms"] = cuda_ms(kern, 20), cuda_ms(plain, 2)
            ops = count_ops(plain)
            n_in, n_out, n_flags = io_values("riccati_fddp", T, ndx, nu)
            target["bound_ms"], target["bound_by"], nbytes = bound(ops, n_in, n_out, n_flags, B, 4)
            target["ops"], target["bytes"] = ops, nbytes
            log(f"  K4 pendulum {label} f32 T={T} B={B}: kernel {target['ms']:.4f} ms (device; "
                f"events {target['events_ms']:.4f}), plain {target['plain_ms']:.4f} ms, bound "
                f"{target['bound_ms']:.4f} ms ({target['bound_by']}: {nbytes} bytes, {ops} ops)")
            big = tuple(a.repeat(*([1] * (a.dim() - 1)), B_FILL // B) for a in args)
            fill = partial(rk.riccati_fddp_backward, *big)
            ms, ev = device_ms(fill, 10, "riccati_fddp_kernel"), cuda_ms(fill, 10)
            bms, by, _ = bound(ops * (B_FILL // B), n_in, n_out, n_flags, B_FILL, 4)
            target.setdefault("variants", {})[f"B={B_FILL}"] = dict(ms=ms, events_ms=ev,
                                                                   bound_ms=bms, bound_by=by)
            log(f"  K4 pendulum {label} f32 T={T} B={B_FILL} (the inputs repeated): kernel "
                f"{ms:.4f} ms (device; events {ev:.4f}), bound {bms:.4f} ms ({by})")
            del big, fill


def kernel_device_time(fn, kernel):
    """(device ms, launches) of ``kernel`` (a kernel function's name) in one
    call of ``fn``, by torch.profiler; the window opens with a launch of its
    own, which takes a record the tracer may drop."""
    from torch.profiler import ProfilerActivity, profile

    from aslr_to_tpu_torch.measure import _device_us

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with quiet(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad.add_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and kernel in evt.key:
            us += _device_us(evt)
            n += evt.count
    return us / 1e3, n


@phase("double pendulum")
def pendulum_phase(report, card):
    """The double-pendulum swing-up (measure.py path double_pendulum: the
    generic route with K4 at (8, 2), T=10, B=4096, f32, maxiter 100, cold
    from the hanging x0 plus 0.05 randn): a first solve, then PENDULUM_TIMED
    timed ones at x0s + 1e-4 (i + 1), with solves/s and the convergence
    accounting; K4
    the only kernel launched; its launches a solve, and its launches and
    device time by torch.profiler over the first PENDULUM_PROFILED passes of
    the last inputs' solve (the row's ``profiled_*`` keys)."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import build_path, path_T, pendulum_solver

    name, expect = "double_pendulum", ("riccati_fddp",)
    p, T = build_path(name), path_T(name)
    prep, t = drive(name, report, p.setup, expect)
    log(f"  first solve: {t:.4f} s")
    for i in range(PENDULUM_TIMED):
        inputs = p.args(i, prep)
        res, t = drive(name, report, lambda: p.solve(*inputs), expect)
        B = res.us.shape[0]
        log(f"  solve {i}: {t:.4f} s, {B / t:.2f} solves/s on {card} (T={T}, B={B}, f32, "
            f"maxiter={p.maxiter}, the generic route)")
    others = {k: n for k, n in build.LAUNCHES.items() if n and k != "riccati_fddp"}
    if others:
        raise AssertionError(f"the double-pendulum path launched other kernels: {others}")
    row = report["riccati_fddp:pendulum"]
    # the profiler takes minutes over a whole solve's million launches: it
    # traces the first PENDULUM_PROFILED passes of the last solve's inputs
    short = pendulum_solver(T, torch.float32, maxiter=PENDULUM_PROFILED)[1]
    build.reset_launches()
    ms, seen = kernel_device_time(lambda: short(*inputs), "riccati_fddp_kernel")
    counted = build.LAUNCHES["riccati_fddp"]
    if seen != counted:
        log(f"  K4: the trace holds {seen} of the {counted} launches")
    row.update(profiled_passes=PENDULUM_PROFILED, profiled_launches=seen, profiled_ms=ms)
    log(f"  K4 in a solve: {row['launches']} launches; in the first {PENDULUM_PROFILED} passes "
        f"{counted} launches, {seen} traced, {ms:.4f} ms of device time by the profiler "
        f"({ms / max(seen, 1):.4f} ms a traced launch), on {card}")
    return summarize(res, B, T, 2, f"{name}, last solve, f32")


def pendulum_parity_check():
    """The double pendulum's generic route in f64 through K4
    (``use_pallas_backward=True``) against the generic sweep on the same
    inputs: T=10, B=64, maxiter 100, the path's x0s. Held: the K4 route
    equals itself with K4's plain version in K4's place to the bit, every
    lane and log; at every pass of it, the generic sweep on the same
    linearization gives the same ok and retryable on every lane, and its k,
    K, w and sums within PENDULUM_SWEEP_RTOL of the sweep's;
    end to end, ``pendulum_lanes_agree``: at least B-1 lanes equal in
    iterations and flags, with equal step lengths and regularizations and
    costs within rtol 1e-8 over the first PENDULUM_LOG_PASSES passes. Over
    100 passes of this solve, which does not converge, rounding differences
    of the two sweeps grow from about 1e-14 to 1e-8 by pass 20 and to 1e-5
    by pass 100 in some lanes (the same on the CPU), so the final costs are
    reported, not held."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.kernels import riccati as rk
    from aslr_to_tpu_torch.measure import (MAXITER_PENDULUM, T_PENDULUM, pendulum_solver,
                                           pendulum_x0s)
    from aslr_to_tpu_torch.solvers import ddp

    B, res, passes = B_PENDULUM_PARITY, {}, []
    backward = ddp._backward

    def lockstep(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds, settings,
                 kprev=None, fast=None):
        out = backward(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds, settings,
                       kprev, fast)
        ref = ddp._backward_scan(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds,
                                 settings, kprev, settings.boxqp_iters)
        flags = torch.equal(out.ok, ref.ok) and torch.equal(out.retryable, ref.retryable)
        errs = [rel_err(getattr(out, f).reshape(B, -1).T, getattr(ref, f).reshape(B, -1).T)[0]
                for f in ("k", "K", "w", "dg", "dq", "dg_gap", "dq_gap", "stop")]
        passes.append((flags, max(errs), int((~out.ok).sum())))
        return out

    for route in ("kernel", "plain", "sweep"):
        w, solve = pendulum_solver(T_PENDULUM, torch.float64, use_pallas_backward=route != "sweep",
                                   keep_log=True)
        x0s = pendulum_x0s(w, B)
        build.reset_launches()
        route_of = rk._route
        t0 = time.perf_counter()
        try:
            if route == "kernel":
                ddp._backward = lockstep
            elif route == "plain":
                rk._route = lambda t: "plain"
            res[route] = solve(x0s)
            torch.cuda.synchronize()
        finally:
            ddp._backward, rk._route = backward, route_of
        n = build.LAUNCHES["riccati_fddp"]
        log(f"  double pendulum f64 T={T_PENDULUM} B={B} maxiter={MAXITER_PENDULUM}, {route} "
            f"route: {time.perf_counter() - t0:.3f} s, K4 launches {n}")
        if (n > 0) != (route == "kernel") or sum(build.LAUNCHES.values()) != n:
            raise AssertionError(f"double pendulum parity: launches {dict(build.LAUNCHES)}")
    k, p = res["kernel"], res["plain"]
    for f in k._fields[:-1]:
        if not same_bits(getattr(k, f).double(), getattr(p, f).double()):
            raise AssertionError(f"double pendulum: the K4 route's {f} differs from the route "
                                 f"through K4's plain version")
    for f in k.log._fields:
        if not same_bits(getattr(k.log, f), getattr(p.log, f)):
            raise AssertionError(f"double pendulum: the K4 route's log {f} differs from the "
                                 f"route through K4's plain version")
    log(f"  double pendulum f64: the K4 route equals the route through K4's plain version to "
        f"the bit ({B} lanes, results and logs)")
    flags_ok = all(f for f, _, _ in passes)
    log(f"  double pendulum f64, each of the K4 route's {len(passes)} backward sweeps against the "
        f"generic sweep on its linearization: ok and retryable "
        f"{'equal on every lane' if flags_ok else 'DIFFER'} ({sum(n for *_, n in passes)} "
        f"lane-sweeps failed to factor in both); largest per-lane relative difference of k, K, "
        f"w and the sums {max(e for _, e, _ in passes):.3e}")
    if not flags_ok:
        raise AssertionError("double pendulum: K4's ok or retryable differ from the generic "
                             "sweep's on the same linearization")
    worst = max(e for _, e, _ in passes)
    if not worst <= PENDULUM_SWEEP_RTOL:
        raise AssertionError(f"double pendulum: K4's k, K, w or sums differ from the generic "
                             f"sweep's by {worst:.3e} > {PENDULUM_SWEEP_RTOL:g}")
    pendulum_lanes_agree(k, res["sweep"], B, x0s)


def pendulum_lanes_agree(a, b, B, x0s):
    """The pendulum's K4 route ``a`` against the generic sweep ``b``: at
    least B - 1 lanes agree, that is equal in iterations and flags and,
    unless the lane diverged in both, over the first PENDULUM_LOG_PASSES
    passes with its cost log within rtol 1e-8 and its step-length and
    regularization logs equal. The final costs are printed, with the pass
    at which each lane's cost logs part."""
    n = PENDULUM_LOG_PASSES
    same = ((a.iterations == b.iterations) & (a.converged == b.converged)
            & (a.diverged == b.diverged))
    agree = same.clone()
    for lane in torch.nonzero(same & ~b.diverged).flatten().tolist():
        agree[lane] = all(first_parting(getattr(a.log, f)[lane, :n], getattr(b.log, f)[lane, :n],
                                        rtol) is None
                          for f, rtol in (("costs", 1e-8), ("steps", 0.0), ("regs", 0.0)))
    live = same & ~b.diverged
    early = ((a.log.costs[live, :n] - b.log.costs[live, :n]).abs()
             / b.log.costs[live, :n].abs()).nan_to_num(0.0)
    c_rel = ((a.cost - b.cost).abs() / b.cost.abs())[live]
    log(f"  double pendulum f64, the K4 route against the generic sweep: {int(agree.sum())}/{B} "
        f"lanes agree ({int(same.sum())} equal in iterations and flags, "
        f"{int((same & b.diverged).sum())} of them diverged in both); largest cost-log rel err "
        f"over passes 0-{n - 1} {float(early.max()) if early.numel() else 0.0:.3e}; final cost "
        f"rel err, reported: largest {float(c_rel.max()) if c_rel.numel() else 0.0:.3e}, "
        f"{int((c_rel > 1e-8).sum())} lanes above 1e-8")
    for lane in range(B):
        j = first_parting(a.log.costs[lane], b.log.costs[lane])
        if j is not None or not bool(agree[lane]):
            log(f"    lane {lane}: iterations {int(a.iterations[lane])} / "
                f"{int(b.iterations[lane])}, flags {'equal' if bool(same[lane]) else 'DIFFER'}, "
                f"cost {float(a.cost[lane])!r} / {float(b.cost[lane])!r}, cost logs part first "
                f"at pass {j}")
    if int(agree.sum()) < B - 1:
        raise AssertionError(f"double pendulum f64: only {int(agree.sum())} of {B} lanes agree")


def pendulum_northstar_check():
    """One f64 scenario of the double pendulum from the preset's x0 through
    ``run_workload`` (the "auto" route: the generic one, with the fast
    path's refusal warned) at the reference's budget, beside
    ``docs/northstar.json``'s record of the JAX package's solve (CPU,
    f64): cost within rtol 1e-6."""
    import warnings

    from aslr_to_tpu_torch import run_workload

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), NORTHSTAR)) as f:
        ref = next(r for r in json.load(f) if r["workload"] == "double_pendulum")
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_workload("double_pendulum", dtype=torch.float64)
        torch.cuda.synchronize()
    for w in caught:
        log(f"  warning: {w.message}")
    r = out.result
    cost, stop, iters = float(r.cost), float(r.stop), int(r.iterations)
    log(f"  double pendulum f64 T={ref['T']} maxiter={ref['maxiter']} on the card: iterations "
        f"{iters} (north star {ref['iterations']}), cost {cost!r} (north star {ref['cost']}, "
        f"{cost / ref['cost'] - 1:+.3e} relative), stop {stop!r} (north star {ref['stop']}), "
        f"converged {bool(r.converged)}, {time.perf_counter() - t0:.3f} s")
    if not abs(cost - ref["cost"]) <= 1e-6 * abs(ref["cost"]):
        raise AssertionError("the double pendulum's north-star cost is not met within rtol 1e-6")


def run_checks(names):
    """A worker: the checks ``names`` of CHECKS, in order, each printed as a
    phase; any failed check raises, so the worker exits non-zero."""
    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on a GPU only")
        sys.exit(2)
    # below the main process, whose phases run beside the workers: a worker
    # waiting on the card spins on its core, and the phases' checks wait on
    # the host as the workers do
    os.nice(WORKER_NICE)
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


def golden(label, fname, w, settings, use_gaps, bounds, warm_start, **homotopy):
    """The lane route's f64 solve from x0 = 0 against ``tests/<fname>``: cost
    rtol 1e-8, iterations equal, us atol 1e-6 (tests/test_golden.py).
    Returns the solve's cost."""
    from aslr_to_tpu_torch import make_batched_solver

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", fname))
    res = make_batched_solver(w.problem, settings, use_gaps=use_gaps, bounds=bounds,
                              warm_start=warm_start, use_fast_path="lanes", **homotopy)(
        torch.zeros(1, 8, dtype=torch.float64, device="cuda"))
    if bool(res.diverged[0]):
        raise AssertionError(f"the {label} solve diverged")
    cost, iters = float(res.cost[0]), int(res.iterations[0])
    us_err = float(np.abs(res.us[0].cpu().numpy() - ref["us"]).max())
    log(f"  {label}: cost {cost} (golden {float(ref['cost'])}), iterations {iters} "
        f"(golden {int(ref['iters'])}), us max abs err {us_err:.3e}")
    if not (abs(cost - float(ref["cost"])) <= 1e-8 * abs(float(ref["cost"]))
            and iters == int(ref["iters"]) and us_err <= 1e-6):
        raise AssertionError(f"the {label} solve does not reproduce {fname}")
    return cost


def golden_check():
    """A worker's: the golden fixtures through the kernels in f64 (the
    T=30 BoxDDP, the quasi-static-warm T=100 SEA FDDP, the T=100
    homotopy held to the JAX package's lane route), and the T=30 golden
    through SolverBoxDDP."""
    from aslr_to_tpu_torch import SolverSettings, stiffness_continuation, two_dof_sea
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.solvers.ddp import SolverBoxDDP

    w = two_dof_vsa_boxddp(T=30, dtype=torch.float64)
    golden("BoxDDP T=30", "golden/vsa_boxddp_T30.npz", w,
           SolverSettings(maxiter=25, th_stop=1e-7), False, w.bounds, False)
    golden("SEA FDDP T=100, quasi-static warm", "golden/sea_T100.npz",
           two_dof_sea(T=100, dtype=torch.float64), SolverSettings(maxiter=100, th_stop=1e-7),
           True, None, True)
    # the staged stiffness-bound continuation of tests/test_golden.py:55-74.
    # Its golden pins the JAX package's generic route; the lane routes end
    # 0.31% higher on this chaotic solve, the port's where JAX's does
    # (tests/data_torch/gen_vsa_homotopy_T100_lanes.py): held to that
    w = two_dof_vsa_boxddp(T=100, dtype=torch.float64)
    scales, ub_stages = stiffness_continuation(w.problem, w.bounds)
    cost = golden("homotopy T=100 (the JAX package's lane route)",
                  "data_torch/vsa_homotopy_T100_lanes.npz", w,
                  SolverSettings(maxiter=20, th_stop=1e-5), False, w.bounds, False,
                  globalization="homotopy", scales=scales, ub_stages=ub_stages)
    generic = float(np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                         "golden", "vsa_homotopy_T100.npz"))["cost"])
    log(f"  homotopy T=100 against the generic route's golden vsa_homotopy_T100.npz: cost "
        f"{cost} against {generic} ({cost / generic - 1:+.3e} relative; not held, as above)")

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

    counts = {}     # each case's operations, counted on its f64 plain call (as in f32)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases, equal_rows = table_kernel_cases(dtype)
        for label, (kern, plain, io_kw, name, ndx, nu, T, B, tbytes, row) in cases.items():
            before = build.LAUNCHES[name]
            got = kern()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{label}: the wrapper did not launch its kernel")
            if tag == "f64":
                want, counts[label] = counted(plain)
            else:
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
            t["ops"] = counts[label] // (2 if name == "rollout1" else 1)
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


def pk_parity_cases():
    """The per-knot routes held to their plain backends in f64 (B=64,
    maxiter MAXITER_PK_PARITY): the MPC at T=60, BoxDDP, BoxFDDP and fast
    BoxDDP in the pinched box at T=40; each (label, path, problem, bounds,
    use_gaps, route, T, expect, settings)."""
    from aslr_to_tpu_torch import SolverSettings, stack_knots, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import T_MPC, mpc_problem, pinched_box

    f64 = torch.float64
    pk_settings = SolverSettings(maxiter=MAXITER_PK_PARITY, th_stop=1e-5, boxqp_warm_iters=2)
    Tb = T_PK_PARITY_BOX
    w = two_dof_vsa_boxddp(T=Tb, dtype=f64)
    stacked = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * Tb),
                                  per_knot=True)
    box = pinched_box(Tb, f64, knots=range(Tb // 2 - 5, Tb // 2 + 5))
    return (("MPC tracking (lanes)", "pk_parity_mpc", mpc_problem(T_MPC, f64), None, True,
             "lanes", T_MPC, ("linearize", "riccati_fddp", "rollout2"),
             SolverSettings(maxiter=MAXITER_PK_PARITY, th_stop=1e-5)),
            ("pinched BoxDDP (lanes)", "pk_parity_boxddp", stacked, box, False, "lanes", Tb,
             ("linearize", "riccati_box", "rollout2"), pk_settings),
            ("pinched BoxFDDP (lanes)", "pk_parity_boxfddp", stacked, box, True, "lanes", Tb,
             ("linearize", "riccati_boxfddp", "rollout2"), pk_settings),
            ("pinched BoxDDP (fast)", "pk_parity_fast_boxddp", stacked, box, False, True, Tb,
             ("linearize", "rollout1"), pk_settings))


def pk_solver(problem, bounds, use_gaps, route, settings, backend):
    from aslr_to_tpu_torch import make_batched_solver

    return make_batched_solver(problem, settings, use_gaps=use_gaps, bounds=bounds,
                               use_fast_path=route, backend=backend)


def pk_parity_launches(report):
    """Each route of pk_parity_cases through the kernels, driven as its
    path (the rows of the box tables' K5 and K6 take their launches from
    two of them); their parity runs in a worker (per_knot_checks)."""
    from aslr_to_tpu_torch.measure import x0_batch

    x0s = x0_batch(B_PK_PARITY, torch.float64, 6)
    for label, path, problem, bounds, use_gaps, route, T, expect, settings in pk_parity_cases():
        solve = pk_solver(problem, bounds, use_gaps, route, settings, "auto")
        _, t = drive(path, report, lambda: solve(x0s), expect)
        log(f"  {label} f64 T={T} B={B_PK_PARITY} through the kernels: {t:.3f} s")


def pk_parity(label, path, problem, bounds, use_gaps, route, T, expect, settings):
    """One f64 solve of a per-knot route through the kernels (every kernel
    in ``expect`` launched) against its plain backend, B=64: at least B-1
    lanes equal in iterations and flags with cost within rtol 1e-8."""
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import x0_batch

    x0s = x0_batch(B_PK_PARITY, torch.float64, 6)
    res = {}
    for backend in ("auto", "plain"):
        solve = pk_solver(problem, bounds, use_gaps, route, settings, backend)
        build.reset_launches()
        t0 = time.perf_counter()
        res[backend] = solve(x0s)
        torch.cuda.synchronize()
        log(f"  {label} f64 T={T} B={B_PK_PARITY} {backend} backend: "
            f"{time.perf_counter() - t0:.3f} s")
        missing = [k for k in expect if build.LAUNCHES[k] <= 0]
        if backend == "auto" and missing:
            raise AssertionError(f"{label}: kernels {missing} were not launched ({path})")
    lanes_equal(f"{label}: kernels against the plain backend", res["auto"], res["plain"],
                B_PK_PARITY, x0s)


@phase("per-knot")
def per_knot_phase(report, card):
    """The per-knot paths (measure.py: mpc_tracking, fast_mpc_tracking,
    pk_boxddp) on the card, f32: solves/s and the convergence accounting,
    the fast route within 3 points of the lane route, the TPU's converged
    share beside the MPC's, and the pinched knots clamped; then the f64
    routes of pk_parity_cases through the kernels, for their launches."""
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
    pk_parity_launches(report)


def per_knot_checks():
    """A worker's: f64 parity of each per-knot route against its plain
    backend (pk_parity_cases), and the generic route against the lane
    route (T=20, B=16)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, stack_knots
    from aslr_to_tpu_torch import two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import mpc_problem, pinched_box, x0_batch

    f64 = torch.float64
    for case in pk_parity_cases():
        pk_parity(*case)

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


def assoc_inputs(T, B, dtype, seed):
    """scripts/bench_assoc.py's backward inputs (ndx 8, nu 4), batch-first on
    the card: near-identity dynamics, SPD cost blocks, gaps 0.05 randn;
    drawn in f64 from a seeded CUDA generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ndx, nu = 8, 4

    def n(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.float64)

    def spd(*lead, m):
        W = 0.3 * n(*lead, m, m)
        return W @ W.mT + 0.5 * torch.eye(m, device="cuda", dtype=torch.float64)

    Fx = torch.eye(ndx, device="cuda", dtype=torch.float64) + 0.02 * n(B, T, ndx, ndx)
    out = (Fx, 0.1 * n(B, T, ndx, nu), n(B, T, ndx), n(B, T, nu), spd(B, T, m=ndx),
           0.05 * n(B, T, ndx, nu), spd(B, T, m=nu), n(B, ndx), spd(B, m=ndx),
           0.05 * n(B, T + 1, ndx))
    return tuple(a.to(dtype) for a in out)


@phase("assoc")
def assoc_phase(smi):
    """The log-depth backward (solvers/assoc_riccati.py, batched torch)
    against the sequential sweep of the generic route (solvers/ddp.py::
    _backward_scan, a loop over the knots) and K4 at (8, 4) (the kernel
    alone, on the same inputs in its lane layout), f32, at each
    (T, B) of ASSOC_T x ASSOC_B: CUDA events over ASSOC_REPS calls after a
    warm-up; the gains of assoc and K4 each held to the sequential sweep's
    within ASSOC_GAIN_RTOL (normwise a lane: f32 reassociation gave
    2.98e-7 to 5.69e-7)."""
    import types

    from aslr_to_tpu_torch.kernels.riccati import riccati_fddp_backward
    from aslr_to_tpu_torch.models.integrator import ActionDerivs
    from aslr_to_tpu_torch.solvers.assoc_riccati import fddp_backward_assoc
    from aslr_to_tpu_torch.solvers.ddp import SolverSettings, _backward_scan

    problem = types.SimpleNamespace(state=types.SimpleNamespace(ndx=8), nu=4)
    rows = []
    for T in ASSOC_T:
        for B in ASSOC_B:
            args = assoc_inputs(T, B, torch.float32, T + B)
            reg = torch.full((B,), 1e-6, device="cuda")
            run = ActionDerivs(*args[:7])
            term = ActionDerivs(None, None, args[7], None, args[8], None, None)
            us = torch.zeros(B, T, 4, device="cuda")
            lanes = [a.movedim(0, -1).contiguous() for a in args] + [reg]
            fns = dict(
                assoc=lambda: fddp_backward_assoc(*args, reg)[0],
                sequential=lambda: _backward_scan(problem, run, term, args[9], us, reg, True,
                                                  None, SolverSettings(), None, 0).k,
                K4=lambda: riccati_fddp_backward(*lanes).k)
            k = {name: fn().float() for name, fn in fns.items()}
            k["K4"] = k["K4"].movedim(-1, 0)
            ms = {name: cuda_ms(fn, ASSOC_REPS) for name, fn in fns.items()}
            diff = {f"{a}-{b}": rel_err(k[a].flatten(1).T, k[b].flatten(1).T)[0]
                    for a, b in (("assoc", "sequential"), ("K4", "sequential"))}
            if not all(bool(torch.isfinite(v).all()) for v in k.values()):
                raise AssertionError(f"assoc T={T} B={B}: non-finite gains")
            if max(diff.values()) > ASSOC_GAIN_RTOL:
                raise AssertionError(f"assoc T={T} B={B}: the gains part by {diff}, over "
                                     f"{ASSOC_GAIN_RTOL}")
            rows.append(dict(T=T, B=B, **{f"{n}_ms": v for n, v in ms.items()}))
            log(f"  T={T} B={B} f32: assoc {ms['assoc']:.4f} ms, sequential "
                f"{ms['sequential']:.4f} ms, K4 {ms['K4']:.4f} ms; assoc / sequential "
                f"{ms['sequential'] / ms['assoc']:.2f}x, K4 / assoc "
                f"{ms['assoc'] / ms['K4']:.2f}x; gains' relative difference {diff} ({smi})")
            del args, run, term, lanes, k
            torch.cuda.empty_cache()
    log(json.dumps({"assoc": rows}))


@phase("fast assoc")
def fast_assoc_phase(report, card):
    """The fast route's SEA cold solve with assoc_backward (measure.py path
    fast_sea_assoc: K1 and K6, the backward in batched torch, no backward
    kernel) beside the same route without it (fast_sea), T=100, B=4096,
    f32, maxiter 60, on the same inputs. The gap in their statistics is
    printed; f32 reassociation on long suffixes may move it a little
    (0.004 mean iterations, median costs 3e-7 apart), so only a gap past
    FAST_ASSOC_GAPS fails, as a wrong backward would."""
    from aslr_to_tpu_torch.kernels import build

    summ = solve_path("fast_sea", report, card, ("linearize", "riccati_fddp", "rollout1"),
                      2, 1)[1]
    assoc = solve_path("fast_sea_assoc", report, card, ("linearize", "rollout1"), 2, 2)[1]
    backward = {k: v for k, v in build.LAUNCHES.items() if k.startswith("riccati")}
    if any(backward.values()):
        raise AssertionError(f"fast_sea_assoc launched a backward kernel: {backward}")
    gaps = {k: assoc[k] - summ[k] for k in ("converged_frac", "diverged_frac",
                                            "mean_iterations", "max_iterations")}
    gaps["median_cost"] = assoc["median_cost"] / summ["median_cost"] - 1
    log(f"  fast SEA with assoc_backward minus without: {gaps}")
    over = {k: v for k, v in gaps.items() if abs(v) > FAST_ASSOC_GAPS[k]}
    if over:
        raise AssertionError(f"fast_sea_assoc parts from fast_sea by {over}, over "
                             f"{FAST_ASSOC_GAPS}")


@phase("sharded")
def sharded_phase(report):
    """sharded_solve over every card of the host on the BoxDDP main path's
    problem, settings and x0s (measure.py path boxddp): equal to the lane
    solve of the same x0s to the bit."""
    from aslr_to_tpu_torch import (SolverSettings, make_batched_solver, sharded_solve,
                                   two_dof_vsa_boxddp)
    from aslr_to_tpu_torch.measure import B_PATH, SEEDS, T_PATH, x0_batch

    w = two_dof_vsa_boxddp(T=T_PATH, dtype=torch.float32)
    settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
    x0s = x0_batch(B_PATH, torch.float32, SEEDS["boxddp"])
    lanes = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                use_fast_path="lanes")(x0s)
    res, t = drive("sharded", report,
                   lambda: sharded_solve(w.problem, x0s, settings, use_gaps=False,
                                         bounds=w.bounds, use_fast_path="lanes"),
                   ("linearize", "riccati_box", "rollout2"))
    differ = [f for f in res._fields[:-1] if not same_bits(getattr(res, f), getattr(lanes, f))]
    if differ:
        raise AssertionError(f"sharded_solve differs from the lane solve in {differ}")
    log(f"  sharded_solve over {torch.cuda.device_count()} device(s), B={B_PATH}: {t:.4f} s, "
        f"equal to the lane solve to the bit")


def spmd_rank(out_dir):
    """A rank of the spmd phase (``chip_smoke.py --spmd-rank DIR``, started
    by spmd_phase through aslr_to_tpu_torch/parallel/launch.py): the BoxDDP
    main path's problem, settings and x0s through shard_map_solve on the
    lane route, a warm-up solve, then, once the parent writes a line (its
    check workers stopped), one solve timed from a barrier before it to a
    barrier after the gathered result, its launches counted. Saves the
    gathered result and the statistics to DIR/rank<r>.pt and prints a JSON
    line "SPMD RANK {...}"."""
    import torch.distributed as dist

    from aslr_to_tpu_torch import SolverSettings, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.kernels import build
    from aslr_to_tpu_torch.measure import B_PATH, SEEDS, T_PATH, x0_batch
    from aslr_to_tpu_torch.parallel.mesh import distributed_init
    from aslr_to_tpu_torch.parallel.spmd import shard_map_solve

    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on a GPU only")
        sys.exit(2)
    mesh = distributed_init()
    try:
        w = two_dof_vsa_boxddp(T=T_PATH, dtype=torch.float32)
        settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
        x0s = x0_batch(B_PATH, torch.float32, SEEDS["boxddp"])

        def solve():
            return shard_map_solve(w.problem, x0s, settings, use_gaps=False, bounds=w.bounds,
                                   use_fast_path="lanes", mesh=mesh)

        solve()
        torch.cuda.synchronize()
        log("SPMD READY")
        sys.stdin.readline()
        mesh.barrier()
        build.reset_launches()
        t0 = time.perf_counter()
        res, (n_conv, mean_cost) = solve()
        torch.cuda.synchronize()
        mesh.barrier()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        log(f"SPMD TIMED {seconds!r}")
        torch.save(dict(result={f: getattr(res, f).cpu() for f in res._fields[:-1]},
                        log={f: getattr(res.log, f).cpu() for f in res.log._fields},
                        stats=torch.stack([n_conv, mean_cost]).cpu()),
                   os.path.join(out_dir, f"rank{mesh.rank}.pt"))
        log("SPMD RANK " + json.dumps(dict(
            rank=mesh.rank, size=mesh.size, device=str(mesh.device), backend=mesh.backend,
            seconds=seconds, launches=launches, n_conv=float(n_conv),
            mean_cost=float(mean_cost), home=build._home, copies=sorted(build._copies))))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@phase("spmd")
def spmd_phase(report, card):
    """The sharded solve across processes: a rank a card over NCCL where
    the host has several, else 2 ranks on card 0 over Gloo (so that a
    collective really crosses processes), each running the BoxDDP main
    path's problem, settings and x0s (measure.py path boxddp) through
    shard_map_solve on the lane route (spmd_rank). Every rank must launch
    K1, K2 and K3 in the timed solve, from a library of its own card's (no
    _device_copy); every rank's gathered result must equal this process's
    single lane solve of the same x0s to the bit in every field; the global
    statistics must be equal on every rank and equal to those computed in
    the same way from that lane solve (n_conv exactly; mean_cost to the bit
    with two ranks, else within the float32 rounding of the sums' other
    order). A rank that fails or overruns SPMD_TIMEOUT_S fails the phase.
    The ranks start beside the check workers; their timed solve runs with
    the workers stopped."""
    import tempfile

    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_vsa_boxddp
    from aslr_to_tpu_torch.measure import B_PATH, SEEDS, T_PATH, x0_batch
    from aslr_to_tpu_torch.parallel import launch
    from aslr_to_tpu_torch.parallel.spmd import stats_of
    from aslr_to_tpu_torch.solvers.ddp import SolveLog, SolveResult

    cards = torch.cuda.device_count()
    n = cards if cards > 1 else 2
    with tempfile.TemporaryDirectory() as d:
        with launch.Ranks(n, [os.path.abspath(__file__), "--spmd-rank", d], SPMD_TIMEOUT_S,
                          stdin=True) as ranks:
            # this process's lane solve of the same x0s, while the ranks start
            w = two_dof_vsa_boxddp(T=T_PATH, dtype=torch.float32)
            settings = SolverSettings(maxiter=20, th_stop=1e-5, boxqp_warm_iters=2)
            x0s = x0_batch(B_PATH, torch.float32, SEEDS["boxddp"])
            lanes = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                        use_fast_path="lanes")(x0s)
            torch.cuda.synchronize()
            ranks.wait_for("SPMD READY")
            with quiet():
                ranks.send("go\n")
                ranks.wait_for("SPMD TIMED")
            texts = ranks.wait()
        saved = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(n)]
    infos = []
    for r, text in enumerate(texts):
        for line in text.splitlines():
            log(f"  [rank {r}] {line}")
            if line.startswith("SPMD RANK "):
                infos.append(json.loads(line.removeprefix("SPMD RANK ")))
    if [i["rank"] for i in infos] != list(range(n)):
        raise AssertionError(f"spmd: the ranks' records {infos}")
    for i in infos:
        missing = [k for k in SPMD_KERNELS if i["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"spmd: rank {i['rank']} launched no {missing}")
        if i["copies"] or f"cuda:{i['home']}" != i["device"]:
            raise AssertionError(f"spmd: rank {i['rank']} on {i['device']} launched from the "
                                 f"library of cuda:{i['home']} and the copies {i['copies']}")
    names = SolveResult._fields[:-1] + SolveLog._fields
    want_leaves = [t.cpu() for t in (*lanes[:-1], *lanes.log)]
    for r, got in enumerate(saved):
        got_leaves = [got["result"].get(f, got["log"].get(f)) for f in names]
        differ = [f for f, a, b in zip(names, got_leaves, want_leaves)
                  if not (a.dtype == b.dtype and a.shape == b.shape and same_bits(a, b))]
        if differ:
            raise AssertionError(f"spmd: rank {r}'s gathered result differs from the lane "
                                 f"solve in {differ}")
    stats = [got["stats"] for got in saved]
    if not all(same_bits(st, stats[0]) for st in stats):
        raise AssertionError(f"spmd: the ranks' global statistics differ: {stats}")
    want = torch.stack(stats_of(lanes, n)).cpu()
    n_conv, mean_cost = stats[0].tolist()
    rounding = n * torch.finfo(torch.float32).eps * abs(float(want[1]))
    exact = same_bits(stats[0], want)
    if not (exact or (n > 2 and n_conv == float(want[0])
                      and abs(mean_cost - float(want[1])) <= rounding)):
        raise AssertionError(f"spmd: the global statistics {stats[0].tolist()} against "
                             f"{want.tolist()} from the lane solve")
    seconds = max(i["seconds"] for i in infos)
    for row, path in ROW_PATH.items():
        if path == "boxddp":
            report[row].setdefault("launches_by_path", {})["spmd"] = sum(
                i["launches"][ROW_KERNEL[row]] for i in infos)
    log(f"  shard_map_solve over {n} ranks ({infos[0]['backend']}, devices "
        f"{[i['device'] for i in infos]}), B={B_PATH}: {seconds:.4f} s from barrier to "
        f"barrier, {B_PATH / seconds:.2f} solves/s on {card}; launches a rank "
        f"{[{k: i['launches'][k] for k in SPMD_KERNELS} for i in infos]}; global statistics "
        f"n_conv {n_conv!r}, mean_cost {mean_cost!r} on every rank, "
        f"{'to the bit' if exact else 'within float32 rounding'} those of the lane solve; "
        f"every gathered result equal to the lane solve to the bit; no rank took "
        f"_device_copy")


@phase("entry points")
def entry_phase(report):
    """aslr_to_tpu_torch/entry.py on the card: entry()'s fn on its example
    x0s (the generic and lane BoxDDP solves, T=20, f32) and
    dryrun_multichip over every card of the host, the shards in series in
    this process (its launches counted here; the process route is the spmd
    phase's)."""
    from aslr_to_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry()
    (cost, gen_us, lane_us), t = drive("entry", report, lambda: fn(*args),
                                       ("linearize", "riccati_box", "rollout2"))
    if not (cost.shape == (4,) and gen_us.shape == lane_us.shape == (4, 20, 4)
            and bool(torch.isfinite(cost).all())):
        raise AssertionError(f"entry(): {cost}, {gen_us.shape}, {lane_us.shape}")
    log(f"  entry(): cost_sum {cost.tolist()} in {t:.4f} s")
    n = torch.cuda.device_count()
    _, t = drive("dryrun_multichip", report, lambda: dryrun_multichip(n, route="series"),
                 ("linearize", "riccati_box", "rollout2", "riccati_fddp"))
    log(f"  dryrun_multichip({n}, route='series'): {t:.4f} s")


def assoc_parity_check():
    """A worker's: the generic route's SEA FDDP solve (T=20, B=64, f64,
    maxiter 8, th_stop 1e-9) with assoc_backward against the sequential
    backward on every lane: iterations and flags equal, cost within rtol
    1e-9, us within atol 1e-7 (the CPU test's criterion)."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea
    from aslr_to_tpu_torch.measure import SEEDS, x0_batch

    w = two_dof_sea(T=20)
    x0s = x0_batch(64, torch.float64, SEEDS["sea_warm"])
    res = {}
    for assoc in (False, True):
        fn = make_batched_solver(w.problem, SolverSettings(maxiter=8, th_stop=1e-9,
                                                           assoc_backward=assoc))
        res[assoc] = fn(x0s)
    seq, par = res[False], res[True]
    ok = ((seq.iterations == par.iterations) & (seq.converged == par.converged)
          & (seq.diverged == par.diverged)
          & ((par.cost - seq.cost).abs() <= 1e-9 * seq.cost.abs())
          & ((par.us - seq.us).abs().flatten(1).amax(1) <= 1e-7))
    worst = float(((par.cost - seq.cost).abs() / seq.cost.abs()).max())
    log(f"  assoc against the sequential backward, generic SEA FDDP f64 T=20 B=64: "
        f"{int(ok.sum())}/64 lanes agree; largest cost difference {worst:.3e} relative; "
        f"iterations {seq.iterations.min().item()}-{seq.iterations.max().item()}")
    if not bool(ok.all()):
        raise AssertionError(f"assoc parity: lanes {torch.nonzero(~ok).flatten().tolist()} "
                             f"part from the sequential backward")


def examples_check():
    """A worker's: each example of aslr_to_tpu_torch/examples/ through its
    main on the card at the test's sizes (tests/test_torch_examples.py)."""
    import tempfile

    from aslr_to_tpu_torch.examples import (batched_sweep, double_pendulum, mpc_resolve,
                                            mpc_tracking, seven_dof_sea, two_dof_sea,
                                            two_dof_vsa_boxddp, two_dof_vsa_modified)

    def finite(res):
        if not bool(torch.isfinite(res.cost).all()):
            raise AssertionError(f"an example's cost is not finite: {res.cost}")

    for module, T in ((two_dof_sea, 10), (seven_dof_sea, 5), (double_pendulum, 5),
                      (two_dof_vsa_modified, 10)):
        finite(module.main(T=T, maxiter=3).result)
    with tempfile.TemporaryDirectory() as d:
        for homotopy in (False, True):
            finite(two_dof_vsa_boxddp.main(T=10, maxiter=4, homotopy=homotopy,
                                           out=os.path.join(d, "vsa.mat")).result)
    finite(batched_sweep.main(batch=4, T=10, maxiter=3, dtype="float64")[0])
    finite(batched_sweep.main(batch=4, T=10, maxiter=3, dtype="float64", spmd=True)[0])
    finite(mpc_resolve.main(T=10, maxiter=20)[1])
    finite(mpc_tracking.main(T=10, maxiter=10)[0])
    finite(mpc_tracking.main(T=10, batch=4, reps=1)[0])
    log("  the 8 examples ran on the card")


# the checks that solve on the plain backend or the generic route, each a
# worker process's: those solves run thousands of small kernels a loop
# pass, so each waits on its host and leaves the card idle, and side by
# side they take the time of the longest. The tuples are the workers (ten,
# on the H100 machine's 8 cores), below this process in priority; they
# start once the build is done and run beside every phase, stopped while a
# phase times (quiet). The nl 7 rollouts at 4 B_NDOF, the longest check,
# run a dtype a worker.
CHECKS = {"parity double pendulum": pendulum_parity_check,
          "parity per-knot": per_knot_checks,
          **{f"nl 7 rollouts at 4 B_NDOF {tag}": partial(nl7_rollouts_check, (4 * B_NDOF,),
                                                          False, None, (tag,))
             for tag in ("f64", "f32")},
          "nl 7 rollouts blown up": partial(nl7_rollouts_check, (B_NDOF, 4 * B_NDOF), True),
          "nl 7 table rollouts": partial(nl7_rollouts_check, (B_NDOF,), False,
                                         "sea gaps target table"),
          "golden": golden_check,
          "pendulum north star": pendulum_northstar_check,
          "parity BoxDDP": partial(parity_check, "BoxDDP"),
          "parity SEA FDDP": partial(parity_check, "SEA FDDP"),
          "parity BoxFDDP": partial(parity_check, "BoxFDDP"),
          "generic BoxDDP": partial(generic_check, "BoxDDP"),
          "generic SEA FDDP": partial(generic_check, "SEA FDDP"),
          "parity homotopy main": partial(homotopy_parity_check, "main"),
          "parity homotopy rescue": partial(homotopy_parity_check, "rescue"),
          **{f"parity 7-DoF {family} {route}{at}": partial(ndof_parity_check, family, route, T)
             for family in NDOF_FAMILIES for route in ("lanes", "fast")
             for at, T in (("", T_NDOF_PARITY), (" T=100", 100))},
          "generic 7-DoF BoxFDDP": partial(ndof_generic_check, "BoxFDDP"),
          "generic 7-DoF DDP": partial(ndof_generic_check, "DDP"),
          "parity assoc": assoc_parity_check,
          "examples": examples_check}
CHECK_WORKERS = (("parity 7-DoF BoxFDDP fast",), ("parity per-knot",),
                 ("parity 7-DoF BoxFDDP lanes", "parity 7-DoF DDP lanes", "parity 7-DoF DDP fast",
                  "golden"),
                 ("parity homotopy rescue", "generic 7-DoF BoxFDDP", "generic 7-DoF DDP"),
                 ("parity homotopy main", "generic BoxDDP", "pendulum north star"),
                 ("parity BoxDDP", "parity SEA FDDP", "generic SEA FDDP"),
                 ("parity BoxFDDP", "parity double pendulum", "nl 7 table rollouts",
                  "nl 7 rollouts blown up"), ("nl 7 rollouts at 4 B_NDOF f64",),
                 ("nl 7 rollouts at 4 B_NDOF f32",), ("parity assoc", "examples"))


def main():
    card, smi = device_phase()
    build_phase()
    report = {name: dict(name=name, route="cuda", **meta, library_ms=None,
                         library_note=NO_LIBRARY) for name, meta in KERNELS.items()}
    # the workers run beside every phase below and are stopped while one
    # of them times (quiet)
    WORKERS.extend(start_checks())
    try:
        spmd_phase(report, smi)
        kernels_phase(report)
        stage_box_kernels_phase(report)
        probe_phase(report)
        ndof_kernels_phase(report)
        ndof_box_kernels_phase(report)
        pendulum_kernels_phase(report)
        lanes_boxddp = main_path_phase(report, smi)
        lanes_sea_cold = sea_warm_phase(report, smi)
        boxfddp_phase(report, smi)
        sevendof_phase(report, smi)
        sevendof_box_phase(report, smi)
        fast_path_phase(report, smi, lanes_boxddp, lanes_sea_cold)
        table_kernels_phase(report)
        per_knot_phase(report, smi)
        homotopy_phase(report, smi)
        pendulum_phase(report, smi)
        generic_timed_phase(smi)
        assoc_phase(smi)
        fast_assoc_phase(report, smi)
        sharded_phase(report)
        entry_phase(report)
        finish_checks(WORKERS)
    finally:
        stop_checks(WORKERS)
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
    elif sys.argv[1:2] == ["--spmd-rank"]:
        spmd_rank(sys.argv[2])
    else:
        main()
