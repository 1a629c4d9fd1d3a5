// K3: the two-trial line-search rollout, and K6: its one-trial launch, of
// the soft arm, VSA or SEA.
//
// K3 replaces the Pallas kernel aslr_to_tpu/pallas/vsa_kernels.py::
// _rolloutn_kernel with n_trials = 2 (:476; built by build_rolloutn :719,
// launched from _rollout_call :571, pallas_call :686); K6 replaces
// _rollout_kernel (:430; the same pallas_call with one trial, built by
// build_rollout :739), the trial of the per-scenario fast path. Both run
// the per-knot step _rollout_trial_step (:365) from the gap-contracted start
// _rollout_x0t (:402). For each trial with its per-scenario step length
// alpha:
//   u_t = clip(u_ref_t - alpha k_t - K_t (x_t - x_ref_t), lb, ub)
//   x_{t+1} = Euler(x_t, dynamics(x_t, u_t)) [+ (alpha - 1) infeas fs_{t+1}]
// the running cost summed in knot order, plus wterm * (terminal goal cost).
// The variants are template parameters: SEA (the actuation), BOXED (the
// clip; compiled out for the unbounded DDP/FDDP families) and GAPS (the FDDP
// gap contraction: x_0 and every step get +(alpha - 1) infeas fs, with
// infeas a per-scenario input that is 0 on a feasible lane).
//
// What bounds it on an H100 at T=100, B=4096, f32: the bytes (a knot and
// scenario reads 48 values for the VSA, 56 with gaps, 28 and 36 for the SEA,
// and a trial writes 12 or 10) take 0.0295-0.0354 ms at 3.35 TB/s; the
// operations (some 2.6-3.3k a trial and knot) about 0.031 ms at the f32
// peak. What bounds it in practice is the latency of the knot chain: every
// trajectory is a serial recursion of T steps, and at B=4096 the card holds
// only 4096 or 8192 trajectories. The earlier design, one thread a
// trajectory, took 0.61-0.83 ms: one warp a scheduler on most SMs, and every
// knot paid the full latency of each dependent step of a chain that held
// three RNEA sweeps, four feedback rows and a running cost in series, with
// the inputs read from global memory at their point of use. This design:
//   - spreads a trajectory over a group of G = 4 lanes of one warp (eight
//     trajectories a warp, 32 a block of 128 threads), so the card holds
//     four times the warps to hide latency with. Every lane runs the same
//     instructions on lane-chosen data: lane j computes feedback row j;
//     lanes 0 .. NL each run one RNEA sweep of mass_nle (the nle, then M's
//     columns; lanes.cuh::mass_nle_sweep); the rows and sweeps meet by
//     shuffles on the group's own mask. The mass solve (2x2 at NL = 2, an
//     unrolled Cholesky above), Binv and Euler run alike on every lane,
//     so the state stays replicated with no further exchange. Sweeps and
//     rows are written for any NL and NU (a lane takes
//     several where the group has fewer lanes);
//   - takes the running cost off the chain, which the next state does not
//     need: lane l keeps (x_t, u_t) of the knots t = l (mod G), and every G
//     knots the group evaluates those G costs at once, one a lane, and
//     folds them into the sum in knot order, the plain version's left fold
//     from 0. The ragged tail (T mod G knots) and the terminal goal cost
//     run once at the end;
//   - stages the knot inputs in shared memory with cp.async, C = 1 knot a
//     stage, each knot a [rows, scenarios] tile coalesced along the batch
//     axis (16-byte copies where the batch stride and the pointers allow,
//     else one element a copy), double-buffered: knot t + 1 is in flight
//     while knot t computes, so no global load sits on the chain. K's rows
//     are staged i-major and a tile row is 32 bytes longer than its
//     scenarios, so the G lanes' rows fall in different banks;
//   - runs K3's two trials in one block as two sets of groups (trial-major:
//     the first SPB groups of a block take trial 0 of its SPB scenarios,
//     the next SPB trial 1), both reading one staged copy of the inputs, as
//     the Pallas kernel shared its loaded inputs between its trials. K6 is
//     the same code launched for one trial, so it equals K3's first trial
//     at the same step length to the bit.
// Per-knot problems (vsa_kernels.py::_tgt_at, the [T, nu] clip of
// _rollout_trial_step) give the kernel a [T, 12] target table and [T, NU]
// box tables in place of the parameter block's target and the lanes' box.
// Those take instances of their own (template parameter TAB = kTables, in
// the units rollout*_tables.cu): a branch on the tables compiled into the
// shared instances cost them spills and up to 28% of their time (PERF.md,
// PR 9). Within a table instance, null pointers tell which tables a launch
// gives (a uniform branch). Each knot's rows ride with its stage into a ring of RING
// slots in shared memory (RollLayout::RING; allocated only when a table is
// given), so no global load joins the chain: the clip of knot t reads slot
// t, and the running cost deferred to the group reads the slot of the knot
// it evaluates (lane l's knot t - G + 1 + l), not the chain's.
// No division of an exact zero sits on the chain at NL = 2 (the 2x2 solve
// divides 1 by the determinant), so boxqp.cuh's zero-dividend skip has no
// use here; the Cholesky above NL = 2 divides by M's factor plainly.
// aslr_to_tpu_torch/rollout_variants.py times each of these choices
// against its alternative on the card (PERF.md): 2 or 8 lanes, the cost in
// the chain, deeper stages and blocks of 64 run slower; blocks of 256 spill
// in f64; direct loads win on the VSA's box and lose on the SEA's gaps.
// Those were measured at nl = 2. At nl = 7 (the 7-DoF arm) the general
// layout's knot chain holds 8 RNEA sweeps and 7 feedback rows of 28
// products on 4 lanes, two of each a lane in series, and at the path's
// B = 1024 its blocks leave most SMs idle (K6: 32 blocks; K3, 16 scenarios
// of two trials a block: 64). There the wide layout (RollLayout::WIDE):
//   - a group of 8 lanes runs one sweep (the nle, or one of M's 7 columns)
//     and at most one row a lane, in blocks of 64 threads for K6 (8
//     trajectories) and of 128 for K3 (8 scenarios of two trials, both
//     still on one staged copy of the knot: a staged row of f32 is a full
//     32-byte sector, about 4.2 copies a thread a knot): 128 blocks each at
//     B = 1024;
//   - lane i computes joint i's rotation (its sine and cosine, the
//     Rodrigues matrix and the product with the joint's placement) once a
//     knot, and the group exchanges the 7 matrices by shuffles, so a sweep
//     computes none of them (kShareRotN7);
//   - in f64 the knot whose running cost a lane defers waits in a
//     shared-memory slot of the lane's, not in 70 registers, which would
//     spill (RollLayout::KEPT).
// K6 takes it at every batch. K3 takes it only where its general layout's
// blocks are fewer than the SMs (rollout2_wide): at B = 4096 every SM holds
// a general block, and the wide layout's twice the lanes, each repeating
// the factor, the solves and the Euler step, ran 32% slower there
// (PERF.md). `rollout_variants.py --nl 7` times each choice against its
// alternative.
//
// Every value is computed by one lane with the operations of the plain
// version (aslr_to_tpu_torch/kernels/vsa_kernels.py::_rollout_plain), in its
// order, and the build has -fmad=false, so every variant equals its plain
// version to the bit. The ragged last block keeps its out-of-range groups in
// every barrier and shuffle: they compute on whatever the stage holds and
// skip their loads and stores.
//
// This header holds the kernel; rollout.cu instantiates it at nl = 2,
// rollout_n3.cu and rollout_n7.cu at 3 and 7, each a translation unit of
// its own so that nvcc compiles them side by side.
#pragma once

#include <cuda_pipeline.h>

#include "lanes.cuh"

namespace aslr {

constexpr int kRollThreads1 = 128;  // a block of K6
constexpr int kRollThreads2 = 128;  // a block of K3
constexpr int kRollGroup = 4;       // lanes a trajectory
constexpr int kRollChunk = 1;       // knots a stage
// the design's choices, each timed against its alternative
constexpr bool kDeferCost = true;   // the running cost off the chain
constexpr bool kStaged = true;      // knot inputs from shared memory
constexpr bool kShareStage = true;  // K3's trials read one staged copy
// Where a chain has more RNEA sweeps (NL + 1) than kRollGroup lanes, nl = 7,
// the wide layout: kRollGroupN7 lanes a trajectory, so each lane runs one
// RNEA sweep and at most one feedback row, in blocks of kRollThreadsN7
// threads for K6 and kRollThreads2N7 for K3 (8 scenarios, a staged row of
// f32 a full 32-byte sector); tuned at the 7-DoF path's B = 1024. K6 takes
// it at every batch, K3 where its general layout would leave SMs without
// a block (rollout2_wide)
constexpr int kRollGroupN7 = 8;
constexpr int kRollThreadsN7 = 64;
constexpr int kRollThreads2N7 = 128;
constexpr bool kShareRotN7 = true;  // each joint's rotation computed by one lane a group

template <class S>
struct Roll {
  const S *xs, *us, *k, *K, *x0, *alpha_a, *alpha_b, *wterm, *lb, *ub, *fs, *infeas;
  // per-knot tables, each null or [T, ...] (row t knot t's): the box
  // [T, NU] in place of lb/ub, the running cost's target [T, 12]
  const S *lbt, *ubt, *tgt;
  int T, B;
  bool vec;  // 16-byte copies: the batch stride and every staged pointer allow them
  S *xs_a, *us_a, *cost_a, *xs_b, *us_b, *cost_b;
};

// A block: NT trials of SPB scenarios, a group of G lanes a trajectory. Its
// shared memory: two stages of C knots, each knot a [ROWS, P] tile
// (COPIES copies of the SPB scenarios' columns, and 32 bytes). The layout:
// WIDE where the chain's sweeps outnumber the general group's lanes (K6;
// K3 there has both, chosen by the batch at launch), else the general one.
template <class S, int NL, bool SEA, bool GAPS, int NT, bool WIDE_ = (NL + 1 > kRollGroup)>
struct RollLayout {
  static constexpr bool WIDE = WIDE_;
  static_assert(!WIDE || NL + 1 > kRollGroup, "wide where the sweeps outnumber the lanes");
  static constexpr int NDX = Arm<NL, SEA>::NDX, NU = Arm<NL, SEA>::NU,
                       G = WIDE ? kRollGroupN7 : kRollGroup, C = kRollChunk;
  static constexpr int THREADS = WIDE ? (NT == 1 ? kRollThreadsN7 : kRollThreads2N7)
                                      : (NT == 1 ? kRollThreads1 : kRollThreads2);
  static constexpr int SPB = THREADS / G / NT;
  static constexpr int COPIES = kShareStage ? 1 : NT;
  static constexpr int VEC = 16 / (int)sizeof(S);
  static constexpr int P = COPIES * SPB + 32 / (int)sizeof(S);
  static_assert(SPB >= 1 && SPB % VEC == 0, "16-byte copies tile the scenarios of a block");
  // a knot's rows: x_ref, u_ref, k, K (i-major: row i NU + j holds K[j][i]),
  // and with gaps the next knot's fs
  static constexpr int rX = 0, rU = NDX, rk = rU + NU, rK = rk + NU, rF = rK + NU * NDX,
                       ROWS = rF + (GAPS ? NDX : 0), STAGE = C * ROWS * P;
  // (the wide layout in f64, where its 70 registers would spill) each
  // thread's slot for the knot (x, u) whose running cost it takes, after
  // the stages
  static constexpr int KEPT = WIDE && sizeof(S) == 8 ? THREADS * (NDX + NU) : 0;
  static constexpr size_t BYTES = ((kStaged ? (size_t)2 * STAGE : 0) + KEPT) * sizeof(S);
  // after the stages, where a per-knot table is given: a ring of RING knots'
  // table rows (the target's 12, then the box's NU and NU), knot t in slot t
  // mod RING. It holds every knot from the oldest whose running cost is
  // still deferred to the newest in flight: 2 C + G - 1 knots
  static constexpr int W = 12 + 2 * NU, RING = pow2_at_least(2 * C + G), oT = 0, oLb = 12,
                       oUb = 12 + NU;
  static constexpr size_t RING_BYTES = kStaged ? (size_t)RING * W * sizeof(S) : 0;
};

// copy knot t of an array [T', rows, B] into the tile rows from dst, the
// block's scenarios b0 .. b0 + SPB, V elements a copy; IMAJOR: the source
// row j NDX + i of K [T, NU, NDX, B] goes to the tile row i NU + j
template <class L, int V, bool IMAJOR, class S>
__device__ inline void stage_rows(S* dst, const S* src, int rows, long long t, long long TB,
                                  int b0, int tid) {
  constexpr int CPR = L::SPB / V;
  const S* base = src + t * rows * TB + b0;
  for (int c = tid; c < rows * CPR; c += L::THREADS) {
    const int r = c / CPR, s0 = (c % CPR) * V;
    const int d = IMAJOR ? (r % L::NDX) * L::NU + r / L::NDX : r;
    if (b0 + s0 < TB)
      for (int n = 0; n < L::COPIES; ++n)
        __pipeline_memcpy_async(dst + d * L::P + n * L::SPB + s0, base + r * TB + s0,
                                V * sizeof(S));
  }
}

template <class L, int V, class S>
__device__ inline void stage_knot(const Roll<S>& a, S* tile, long long t, int b0, int tid) {
  const long long TB = a.B;
  stage_rows<L, V, false>(tile + L::rX * L::P, a.xs, L::NDX, t, TB, b0, tid);
  stage_rows<L, V, false>(tile + L::rU * L::P, a.us, L::NU, t, TB, b0, tid);
  stage_rows<L, V, false>(tile + L::rk * L::P, a.k, L::NU, t, TB, b0, tid);
  stage_rows<L, V, true>(tile + L::rK * L::P, a.K, L::NU * L::NDX, t, TB, b0, tid);
  if constexpr (L::ROWS > L::rF)
    stage_rows<L, V, false>(tile + L::rF * L::P, a.fs, L::NDX, t + 1, TB, b0, tid);
}

// knot t's rows of the tables given into its ring slot, an element a thread
template <class L, class S>
__device__ inline void stage_table_rows(const Roll<S>& a, S* ring, long long t, int tid) {
  S* const slot = ring + (t % L::RING) * L::W;
  const S* src = nullptr;
  if (tid < 12) src = a.tgt ? a.tgt + t * 12 + tid : nullptr;
  else if (tid < L::oUb) src = a.lbt ? a.lbt + t * L::NU + (tid - L::oLb) : nullptr;
  else if (tid < L::W) src = a.ubt ? a.ubt + t * L::NU + (tid - L::oUb) : nullptr;
  if (src) __pipeline_memcpy_async(slot + tid, src, sizeof(S));
}

// the knots t0 .. t0 + C (those below T) into one stage, and (an instance
// that takes the tables, TAB) their table rows into the ring, as one commit
template <class L, int TAB, class S>
__device__ inline void stage_chunk(const Roll<S>& a, S* stage, S* ring, int t0, int b0,
                                   int tid) {
  for (int kk = 0; kk < L::C && t0 + kk < a.T; ++kk) {
    S* const tile = stage + kk * L::ROWS * L::P;
    if (a.vec) stage_knot<L, L::VEC>(a, tile, t0 + kk, b0, tid);
    else stage_knot<L, 1>(a, tile, t0 + kk, b0, tid);
    if constexpr (TAB != kShared)
      if (a.tgt || a.lbt) stage_table_rows<L>(a, ring, t0 + kk, tid);
  }
  __pipeline_commit();
}

// knot tk's row of a table: its ring slot, or (kStaged false) global memory
template <class L, class S>
__device__ inline const S* table_row(const Roll<S>& a, const S* ring, const S* table,
                                     long long tk, int width, int off) {
  if constexpr (kStaged) return ring + (tk % L::RING) * L::W + off;
  else return table + tk * width;
}

// knot t's inputs of one trajectory: its column of the knot's tile, or
// (kStaged false) global memory; and knot t's box rows
template <class L, class S>
struct KnotIn {
  const S* st;
  const S* ring;
  const Roll<S>& a;
  long long t, bc;
  __device__ S lbt(int j) const { return table_row<L>(a, ring, a.lbt, t, L::NU, L::oLb)[j]; }
  __device__ S ubt(int j) const { return table_row<L>(a, ring, a.ubt, t, L::NU, L::oUb)[j]; }
  __device__ S xref(int i) const {
    if constexpr (kStaged) return st[(L::rX + i) * L::P];
    else return a.xs[(t * L::NDX + i) * a.B + bc];
  }
  __device__ S uref(int j) const {
    if constexpr (kStaged) return st[(L::rU + j) * L::P];
    else return a.us[(t * L::NU + j) * a.B + bc];
  }
  __device__ S kff(int j) const {
    if constexpr (kStaged) return st[(L::rk + j) * L::P];
    else return a.k[(t * L::NU + j) * a.B + bc];
  }
  __device__ S Kfb(int j, int i) const {
    if constexpr (kStaged) return st[(L::rK + i * L::NU + j) * L::P];
    else return a.K[((t * L::NU + j) * L::NDX + i) * a.B + bc];
  }
  __device__ S fs_next(int i) const {
    if constexpr (kStaged) return st[(L::rF + i) * L::P];
    else return a.fs[((t + 1) * L::NDX + i) * a.B + bc];
  }
};

// cost + the first n lanes' values, in lane order, on every lane
template <int G, class S>
__device__ inline S fold(const Group<G>& grp, S cost, S mine, int n) {
  for (int l = 0; l < G; ++l) {
    const S c = grp.from(l, mine);
    if (l < n) cost = cost + c;
  }
  return cost;
}

template <class S, int NL, bool SEA, bool BOXED, bool GAPS, int NT, int TAB, bool WIDE>
__device__ inline void rollout_group(const VSAParams<NL>& P, const Roll<S>& a) {
  using L = RollLayout<S, NL, SEA, GAPS, NT, WIDE>;
  constexpr int NDX = L::NDX, NU = L::NU;
  constexpr int G = L::G;
  constexpr int MU = (NU + G - 1) / G;      // feedback rows a lane
  constexpr int MS = (NL + 1 + G - 1) / G;  // RNEA sweeps a lane
  // the joints' rotations computed once a group, a joint a lane (one sweep
  // a lane: the wide layout)
  constexpr bool SHARE_ROT = L::WIDE && kShareRotN7 && MS == 1;
  extern __shared__ __align__(16) unsigned char roll_smem[];
  S* const stages = reinterpret_cast<S*>(roll_smem);
  S* const kept = stages + 2 * L::STAGE + threadIdx.x * (L::NDX + L::NU);
  S* const ring = stages + 2 * L::STAGE + L::KEPT;
  const int tid = threadIdx.x, g = tid / G;
  const Group<G> grp;
  const int lane = grp.lane;
  const int trial = g / L::SPB, s = g % L::SPB;
  const int col = s + (L::COPIES > 1 ? trial * L::SPB : 0);
  const int b0 = blockIdx.x * L::SPB;
  const long long TB = a.B, b = b0 + s;
  const bool live = b < TB;
  const long long bc = live ? b : TB - 1;  // where an out-of-range group reads
  const bool first = trial == 0;
  S* const xs_o = first ? a.xs_a : a.xs_b;
  S* const us_o = first ? a.us_a : a.us_b;
  S* const cost_o = first ? a.cost_a : a.cost_b;
  const S alpha = first ? a.alpha_a[bc] : a.alpha_b[bc];
  const int nchunks = (a.T + L::C - 1) / L::C;
  if constexpr (kStaged)
    if (nchunks > 0) stage_chunk<L, TAB>(a, stages, ring, 0, b0, tid);
  // which tables this launch reads (a uniform branch; none in the shared
  // instance, TAB = kShared)
  const bool tgt_tab = TAB != kShared && a.tgt != nullptr;
  const bool box_tab = TAB != kShared && a.lbt != nullptr;

  // this lane's feedback rows (lane + m G) mod NU and their box: its own
  // lanes of lb/ub, or (box_tab) each knot's rows of the tables
  int jr[MU];
  S lo[MU], hi[MU];
  for (int m = 0; m < MU; ++m) {
    jr[m] = (lane + m * G) % NU;
    if constexpr (BOXED) {
      if (!box_tab) {
        lo[m] = a.lb[jr[m] * TB + bc];
        hi[m] = a.ub[jr[m] * TB + bc];
      }
    }
  }
  // knot tk's running cost: against its row of the target table, or the
  // parameter block's target
  auto run_cost = [&](const S* xk_, const S* uk_, long long tk) {
    const S* row = nullptr;
    if (tgt_tab) row = table_row<L>(a, ring, a.tgt, tk < a.T ? tk : a.T - 1, 12, L::oT);
    return running_cost<S, NL, SEA>(P, xk_, uk_, row);
  };
  // the joint whose rotation this lane computes (SHARE_ROT)
  Joint joint;
  if constexpr (SHARE_ROT) joint = joint_of<NL>(P, lane < NL ? lane : 0);
  S gscale = S(0);
  if constexpr (GAPS) gscale = (alpha - S(1)) * a.infeas[bc];
  S x[NDX], xk[NDX], uk[NU];  // (xk, uk): the knot whose running cost this lane takes
  for (int i = 0; i < NDX; ++i) {
    x[i] = a.x0[i * TB + bc];
    if constexpr (GAPS) x[i] = x[i] + a.fs[i * TB + bc] * gscale;
    if (live && i % G == lane) xs_o[i * TB + b] = x[i];
    xk[i] = x[i];
  }
  for (int j = 0; j < NU; ++j) uk[j] = S(0);
  // the kept knot from its slot (L::KEPT), where it waits out the chain
  auto load_kept = [&]() {
    if constexpr (L::KEPT > 0) {
      for (int i = 0; i < NDX; ++i) xk[i] = kept[i];
      for (int j = 0; j < NU; ++j) uk[j] = kept[NDX + j];
    }
  };
  if constexpr (L::KEPT > 0) {
    for (int i = 0; i < NDX; ++i) kept[i] = xk[i];
    for (int j = 0; j < NU; ++j) kept[NDX + j] = uk[j];
  }
  S cost = S(0);

  for (int c = 0; c < nchunks; ++c) {
    if constexpr (kStaged) {
      __pipeline_wait_prior(0);
      __syncthreads();  // chunk c staged; every lane done with chunk c - 1's stage
      if (c + 1 < nchunks)
        stage_chunk<L, TAB>(a, stages + ((c + 1) & 1) * L::STAGE, ring, (c + 1) * L::C, b0,
                            tid);
    }
    for (int kk = 0; kk < L::C; ++kk) {
      const int t = c * L::C + kk;
      if (t >= a.T) break;
      const KnotIn<L, S> in{stages + (c & 1) * L::STAGE + kk * L::ROWS * L::P + col, ring, a,
                            t, bc};

      // feedback rows: u_j = u_ref_j - (alpha k_j + K_j dx), clipped
      S dx[NDX];
      for (int i = 0; i < NDX; ++i) dx[i] = x[i] - in.xref(i);
      S um[MU];
      for (int m = 0; m < MU; ++m) {
        S fb = in.kff(jr[m]) * alpha;
        for (int i = 0; i < NDX; ++i) fb = fb + in.Kfb(jr[m], i) * dx[i];
        um[m] = in.uref(jr[m]) - fb;
        if constexpr (BOXED) {
          if (box_tab) um[m] = dclip(um[m], in.lbt(jr[m]), in.ubt(jr[m]));
          else um[m] = dclip(um[m], lo[m], hi[m]);
        }
        if (live && lane + m * G < NU) us_o[((long long)t * NU + jr[m]) * TB + b] = um[m];
      }
      S u[NU];
      for (int j = 0; j < NU; ++j) u[j] = grp.from(j % G, um[j / G]);

      // the RNEA sweeps of mass_nle, sweep cs on lane cs mod G
      S sw[MS][NL];
      if constexpr (SHARE_ROT) {
        // lane i (i < NL) computes joint i's rotation, which every sweep of
        // the group reads
        S qi = x[0];
        for (int i = 1; i < NL; ++i) qi = lane == i ? x[i] : qi;
        const Mat3<S> mine = joint_rotation(joint, qi);
        Mat3<S> Es[NL];
        for (int i = 0; i < NL; ++i)
          for (int r = 0; r < 3; ++r)
            for (int c3 = 0; c3 < 3; ++c3) Es[i].m[r][c3] = grp.from(i, mine.m[r][c3]);
        const int cs = lane < NL ? lane : NL;
        mass_nle_sweep<S, NL, true>(P, x, x + 2 * NL, cs, sw[0], Es);
      } else {
        for (int m = 0; m < MS; ++m) {
          const int cs = lane + m * G < NL ? lane + m * G : NL;
          mass_nle_sweep<S, NL>(P, x, x + 2 * NL, cs, sw[m]);
        }
      }
      S M[NL][NL], nle[NL];
      for (int i = 0; i < NL; ++i) nle[i] = grp.from(0, sw[0][i]);
      for (int j = 0; j < NL; ++j)
        for (int i = 0; i < NL; ++i) M[i][j] = grp.from((j + 1) % G, sw[(j + 1) / G][i]);

      // the accelerations and the Euler step, alike on every lane
      S tau_c[NL], acc[2 * NL], xn[NDX];
      spring_torque<S, NL, SEA>(P, x, u, tau_c);
      accelerations<S, NL>(P, u, tau_c, M, nle, acc);
      if constexpr (kDeferCost) {
        const bool keep = t % G == lane;
        if constexpr (L::KEPT > 0) {
          if (keep) {
            for (int i = 0; i < NDX; ++i) kept[i] = x[i];
            for (int j = 0; j < NU; ++j) kept[NDX + j] = u[j];
          }
        } else {
          for (int i = 0; i < NDX; ++i) xk[i] = keep ? x[i] : xk[i];
          for (int j = 0; j < NU; ++j) uk[j] = keep ? u[j] : uk[j];
        }
      } else {
        cost = cost + run_cost(x, u, t);
      }
      euler<S, NL>(P.dt, x, acc, xn);
      for (int i = 0; i < NDX; ++i) {
        x[i] = xn[i];
        if constexpr (GAPS) x[i] = x[i] + in.fs_next(i) * gscale;
        if (live && i % G == lane) xs_o[((long long)(t + 1) * NDX + i) * TB + b] = x[i];
      }
      // the G knots t - G + 1 .. t, lane l's the knot t - G + 1 + l
      if constexpr (kDeferCost)
        if (t % G == G - 1) {
          load_kept();
          cost = fold(grp, cost, run_cost(xk, uk, t - (G - 1) + lane), G);
        }
    }
  }
  if constexpr (kDeferCost)
    if (a.T % G) {
      load_kept();
      cost = fold(grp, cost, run_cost(xk, uk, (long long)(a.T / G) * G + lane), a.T % G);
    }
  S r6[6];
  const S goal = goal_cost<S, NL>(P, x, true, (const S*)nullptr, r6);
  if (live && lane == 0) cost_o[b] = cost + a.wterm[bc] * goal;
}

// two entry kernels over one body, so that a profile tells K3 from K6; K3's
// in either layout
template <class S, int NL, bool SEA, bool BOXED, bool GAPS, int TAB>
__global__ void __launch_bounds__(RollLayout<S, NL, SEA, GAPS, 1>::THREADS)
    rollout1_kernel(const VSAParams<NL> P, const Roll<S> a) {
  rollout_group<S, NL, SEA, BOXED, GAPS, 1, TAB, RollLayout<S, NL, SEA, GAPS, 1>::WIDE>(P, a);
}

template <class S, int NL, bool SEA, bool BOXED, bool GAPS, int TAB, bool WIDE>
__global__ void __launch_bounds__(RollLayout<S, NL, SEA, GAPS, 2, WIDE>::THREADS)
    rollout2_kernel(const VSAParams<NL> P, const Roll<S> a) {
  rollout_group<S, NL, SEA, BOXED, GAPS, 2, TAB, WIDE>(P, a);
}

// K3's layout at a batch of B where the chain has both (nl 7): the wide one
// while the general one's blocks are fewer than the card's SMs. There the
// general layout leaves SMs idle, and the wide one, with twice the lanes
// and half the chain a lane, fills them; once every SM has a general block,
// the wide layout's repeated work (the factor, the solves and the Euler
// step on every lane of a group) and its two waves cost more than it gains
// (PERF.md)
template <class S, int NL, bool SEA, bool GAPS>
static bool rollout2_wide(int B) {
  if constexpr (NL + 1 <= kRollGroup) {
    return false;
  } else {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
    const int grid = (B + RollLayout<S, NL, SEA, GAPS, 2, false>::SPB - 1) /
                     RollLayout<S, NL, SEA, GAPS, 2, false>::SPB;
    return grid < sms;
  }
}

template <class S, int NL, int NT, int TAB, bool SEA, bool BOXED, bool GAPS, bool WIDE>
static int launch_layout(const VSAParams<NL>& P, const Roll<S>& a, cudaStream_t stream) {
  using L = RollLayout<S, NL, SEA, GAPS, NT, WIDE>;
  // the ring only in an instance that takes the tables, and only where a
  // table is given
  constexpr size_t MAX = L::BYTES + (TAB != kShared ? L::RING_BYTES : 0);
  static_assert(MAX <= kMaxSmem, "the stages and the ring fit in a block's shared memory");
  const int grid = (a.B + L::SPB - 1) / L::SPB;
  const size_t smem = TAB != kShared && (a.tgt || a.lbt) ? MAX : L::BYTES;
  if constexpr (NT == 1) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        rollout1_kernel<S, NL, SEA, BOXED, GAPS, TAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX);
    if (attr != cudaSuccess) return (int)attr;
    rollout1_kernel<S, NL, SEA, BOXED, GAPS, TAB><<<grid, L::THREADS, smem, stream>>>(P, a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        rollout2_kernel<S, NL, SEA, BOXED, GAPS, TAB, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX);
    if (attr != cudaSuccess) return (int)attr;
    rollout2_kernel<S, NL, SEA, BOXED, GAPS, TAB, WIDE><<<grid, L::THREADS, smem, stream>>>(P, a);
  }
  return (int)cudaGetLastError();
}

template <class S, int NL, int NT, int TAB, bool SEA, bool BOXED, bool GAPS>
static int launch_variant(const VSAParams<NL>& P, const Roll<S>& a, cudaStream_t stream) {
  if constexpr (NT == 2 && NL + 1 > kRollGroup) {
    if (rollout2_wide<S, NL, SEA, GAPS>(a.B))
      return launch_layout<S, NL, NT, TAB, SEA, BOXED, GAPS, true>(P, a, stream);
    return launch_layout<S, NL, NT, TAB, SEA, BOXED, GAPS, false>(P, a, stream);
  } else {
    return launch_layout<S, NL, NT, TAB, SEA, BOXED, GAPS,
                         RollLayout<S, NL, SEA, GAPS, NT>::WIDE>(P, a, stream);
  }
}

// ntrials 1 (K6: alpha_b and the b outputs unused) or 2 (K3) at the chain
// length NL of the including unit; lb/ub (or lbt/ubt) null: no box;
// fs/infeas null: no gaps. Every variant at NL = 2; above it the SEA arm's
// unboxed FDDP rollout with gaps only (the unboxed DDP family has no
// backward kernel, kernels/riccati.py::riccati_batch_major). TAB: the
// unit's instances take no tables (kShared), or some (kTables: the rollout
// units *_tables.cu). kNoInstance otherwise
template <class S, int NT, int NL, int TAB>
static int launch_rollout(const double* params, int nl, Roll<S> a, void* stream) {
  const bool tables = a.tgt || a.lbt;
  if (nl != NL || (TAB == kShared && tables) || (TAB == kTables && !tables)) return kNoInstance;
  const VSAParams<NL> P = unpack_params<NL>(params);
  const void* staged[] = {a.xs, a.us, a.k, a.K, a.fs};
  a.vec = a.B % (16 / (int)sizeof(S)) == 0;
  for (const void* p : staged) a.vec = a.vec && aligned16(p);
  cudaStream_t st = (cudaStream_t)stream;
  const int v = (P.sea ? 4 : 0) + (a.lb || a.lbt ? 2 : 0) + (a.fs ? 1 : 0);
  if constexpr (NL != 2) {
    return v == 5 ? launch_variant<S, NL, NT, TAB, true, false, true>(P, a, st) : kNoInstance;
  } else {
    switch (v) {
      case 0: return launch_variant<S, NL, NT, TAB, false, false, false>(P, a, st);
      case 1: return launch_variant<S, NL, NT, TAB, false, false, true>(P, a, st);
      case 2: return launch_variant<S, NL, NT, TAB, false, true, false>(P, a, st);
      case 3: return launch_variant<S, NL, NT, TAB, false, true, true>(P, a, st);
      case 4: return launch_variant<S, NL, NT, TAB, true, false, false>(P, a, st);
      case 5: return launch_variant<S, NL, NT, TAB, true, false, true>(P, a, st);
      case 6: return launch_variant<S, NL, NT, TAB, true, true, false>(P, a, st);
      default: return launch_variant<S, NL, NT, TAB, true, true, true>(P, a, st);
    }
  }
}

// K3 (NT 2) or K6 (1) at the chain length NL, the SEA arm's unboxed gap
// instance of the shared problem, at a batch of B, in the layout its
// launch takes there: its grid, threads a block, dynamic shared memory,
// blocks resident an SM and layout (1 wide), into out[0 .. 5)
template <class S, int NL, int NT, bool WIDE>
static int roll_launch_layout(int B, int* out) {
  using L = RollLayout<S, NL, true, true, NT, WIDE>;
  void (*kernel)(const VSAParams<NL>, const Roll<S>);
  if constexpr (NT == 1) kernel = rollout1_kernel<S, NL, true, false, true, kShared>;
  else kernel = rollout2_kernel<S, NL, true, false, true, kShared, WIDE>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  out[0] = (B + L::SPB - 1) / L::SPB;
  out[1] = L::THREADS;
  out[2] = (int)L::BYTES;
  out[4] = WIDE;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, L::THREADS,
                                                            L::BYTES);
}

template <class S, int NL, int NT>
static int roll_launch(int B, int* out) {
  if constexpr (NT == 2 && NL + 1 > kRollGroup) {
    if (rollout2_wide<S, NL, true, true>(B)) return roll_launch_layout<S, NL, NT, true>(B, out);
    return roll_launch_layout<S, NL, NT, false>(B, out);
  } else {
    return roll_launch_layout<S, NL, NT, RollLayout<S, NL, true, true, NT>::WIDE>(B, out);
  }
}

template <class S, int NL, bool WIDE>
static int roll_bytes_layout(int ntrials, int sea, int gaps) {
  const int v = (sea ? 2 : 0) + (gaps ? 1 : 0);
  if (ntrials == 1) {
    switch (v) {
      case 0: return (int)RollLayout<S, NL, false, false, 1>::BYTES;
      case 1: return (int)RollLayout<S, NL, false, true, 1>::BYTES;
      case 2: return (int)RollLayout<S, NL, true, false, 1>::BYTES;
      default: return (int)RollLayout<S, NL, true, true, 1>::BYTES;
    }
  }
  switch (v) {
    case 0: return (int)RollLayout<S, NL, false, false, 2, WIDE>::BYTES;
    case 1: return (int)RollLayout<S, NL, false, true, 2, WIDE>::BYTES;
    case 2: return (int)RollLayout<S, NL, true, false, 2, WIDE>::BYTES;
    default: return (int)RollLayout<S, NL, true, true, 2, WIDE>::BYTES;
  }
}

// wide: K3's layout (K6 has one at each chain length); -1 for a layout the
// chain length has no K3 of
template <class S, int NL>
static int roll_bytes_nl(int ntrials, int sea, int gaps, int wide) {
  if constexpr (NL + 1 > kRollGroup) {
    if (wide) return roll_bytes_layout<S, NL, true>(ntrials, sea, gaps);
  } else {
    if (wide && ntrials == 2) return kNoInstance;
  }
  return roll_bytes_layout<S, NL, false>(ntrials, sea, gaps);
}

template <class S>
static int roll_bytes(int nl, int ntrials, int sea, int gaps, int wide) {
  switch (nl) {
    case 2: return roll_bytes_nl<S, 2>(ntrials, sea, gaps, wide);
    case 3: return roll_bytes_nl<S, 3>(ntrials, sea, gaps, wide);
    case 7: return roll_bytes_nl<S, 7>(ntrials, sea, gaps, wide);
    default: return kNoInstance;
  }
}

}  // namespace aslr

// one C entry a scalar type: NAME launches K3 at the chain length NL, with the
// instances of table mode TAB
#define ASLR_ROLLOUT2_ENTRY(NAME, S, NL, TAB)                                              \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha_a, const S* alpha_b,         \
                      const S* wterm, const S* lb, const S* ub, const S* lbt,              \
                      const S* ubt, const S* fs, const S* infeas, const S* tgt, int T,     \
                      int B, S* xs_a, S* us_a, S* cost_a, S* xs_b, S* us_b, S* cost_b,     \
                      void* stream) {                                                      \
    aslr::Roll<S> a{xs,  us,   k,  K,    x0,   alpha_a, alpha_b, wterm, lb,   ub,         \
                    fs,  infeas, lbt, ubt, tgt, T,       B,       false, xs_a, us_a,       \
                    cost_a, xs_b, us_b, cost_b};                                           \
    return aslr::launch_rollout<S, 2, NL, TAB>(params, nl, a, stream);                     \
  }

// the same for K6
#define ASLR_ROLLOUT1_ENTRY(NAME, S, NL, TAB)                                              \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha, const S* wterm,             \
                      const S* lb, const S* ub, const S* lbt, const S* ubt, const S* fs,   \
                      const S* infeas, const S* tgt, int T, int B, S* xs_o, S* us_o,       \
                      S* cost_o, void* stream) {                                           \
    aslr::Roll<S> a{xs,  us,     k,   K,   x0,  alpha, nullptr, wterm, lb,   ub,          \
                    fs,  infeas, lbt, ubt, tgt, T,     B,       false, xs_o, us_o,        \
                    cost_o, nullptr, nullptr, nullptr};                                    \
    return aslr::launch_rollout<S, 1, NL, TAB>(params, nl, a, stream);                     \
  }

// the launch of K3 (ntrials 2) or K6 (1) at the unit's chain length NL (the
// SEA arm, unboxed, with gaps) for 4- or 8-byte scalars at a batch of B:
// grid, threads, dynamic shared memory, blocks resident an SM and the
// layout (1 wide) into out[0 .. 5); the CUDA error, or -1 for another
// ntrials or itemsize
#define ASLR_ROLLOUT_LAUNCH_ENTRY(NAME, NL)                                              \
  extern "C" int NAME(int ntrials, int itemsize, int B, int* out) {                        \
    if (itemsize != 4 && itemsize != 8) return aslr::kNoInstance;                          \
    if (ntrials == 1)                                                                      \
      return itemsize == 4 ? aslr::roll_launch<float, NL, 1>(B, out)                      \
                           : aslr::roll_launch<double, NL, 1>(B, out);                    \
    if (ntrials == 2)                                                                      \
      return itemsize == 4 ? aslr::roll_launch<float, NL, 2>(B, out)                      \
                           : aslr::roll_launch<double, NL, 2>(B, out);                    \
    return aslr::kNoInstance;                                                              \
  }
