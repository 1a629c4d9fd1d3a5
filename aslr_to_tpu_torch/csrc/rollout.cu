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
//     shuffles on the group's own mask. The 2x2 solve, Binv and Euler run
//     alike on every lane, so the state stays replicated with no further
//     exchange. Sweeps and rows are written for any NL and NU (a lane takes
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
// No division of an exact zero sits on the chain (the 2x2 solve divides 1
// by the determinant), so boxqp.cuh's zero-dividend skip has no use here.
// aslr_to_tpu_torch/rollout_variants.py times each of these choices
// against its alternative on the card (PERF.md): 2 or 8 lanes, the cost in
// the chain, deeper stages and blocks of 64 run slower; blocks of 256 spill
// in f64; direct loads win on the VSA's box and lose on the SEA's gaps.
//
// Every value is computed by one lane with the operations of the plain
// version (aslr_to_tpu_torch/kernels/vsa_kernels.py::_rollout_plain), in its
// order, and the build has -fmad=false, so every variant equals its plain
// version to the bit. The ragged last block keeps its out-of-range groups in
// every barrier and shuffle: they compute on whatever the stage holds and
// skip their loads and stores.
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

template <class S>
struct Roll {
  const S *xs, *us, *k, *K, *x0, *alpha_a, *alpha_b, *wterm, *lb, *ub, *fs, *infeas;
  int T, B;
  bool vec;  // 16-byte copies: the batch stride and every staged pointer allow them
  S *xs_a, *us_a, *cost_a, *xs_b, *us_b, *cost_b;
};

// A block: NT trials of SPB scenarios, a group of G lanes a trajectory. Its
// shared memory: two stages of C knots, each knot a [ROWS, P] tile
// (COPIES copies of the SPB scenarios' columns, and 32 bytes).
template <class S, int NDX_, int NU_, bool GAPS, int NT>
struct RollLayout {
  static constexpr int NDX = NDX_, NU = NU_, G = kRollGroup, C = kRollChunk;
  static constexpr int THREADS = NT == 1 ? kRollThreads1 : kRollThreads2;
  static constexpr int SPB = THREADS / G / NT;
  static constexpr int COPIES = kShareStage ? 1 : NT;
  static constexpr int VEC = 16 / (int)sizeof(S);
  static constexpr int P = COPIES * SPB + 32 / (int)sizeof(S);
  static_assert(SPB >= 1 && SPB % VEC == 0, "16-byte copies tile the scenarios of a block");
  // a knot's rows: x_ref, u_ref, k, K (i-major: row i NU + j holds K[j][i]),
  // and with gaps the next knot's fs
  static constexpr int rX = 0, rU = NDX, rk = rU + NU, rK = rk + NU, rF = rK + NU * NDX,
                       ROWS = rF + (GAPS ? NDX : 0), STAGE = C * ROWS * P;
  static constexpr size_t BYTES = kStaged ? (size_t)2 * STAGE * sizeof(S) : 0;
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

// the knots t0 .. t0 + C (those below T) into one stage, as one commit
template <class L, class S>
__device__ inline void stage_chunk(const Roll<S>& a, S* stage, int t0, int b0, int tid) {
  for (int kk = 0; kk < L::C && t0 + kk < a.T; ++kk) {
    S* const tile = stage + kk * L::ROWS * L::P;
    if (a.vec) stage_knot<L, L::VEC>(a, tile, t0 + kk, b0, tid);
    else stage_knot<L, 1>(a, tile, t0 + kk, b0, tid);
  }
  __pipeline_commit();
}

// knot t's inputs of one trajectory: its column of the knot's tile, or
// (kStaged false) global memory
template <class L, class S>
struct KnotIn {
  const S* st;
  const Roll<S>& a;
  long long t, bc;
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

template <class S, int NL, bool SEA, bool BOXED, bool GAPS, int NT>
__device__ inline void rollout_group(const VSAParams<NL>& P, const Roll<S>& a) {
  constexpr int NDX = Arm<NL, SEA>::NDX, NU = Arm<NL, SEA>::NU;
  using L = RollLayout<S, NDX, NU, GAPS, NT>;
  constexpr int G = L::G;
  constexpr int MU = (NU + G - 1) / G;      // feedback rows a lane
  constexpr int MS = (NL + 1 + G - 1) / G;  // RNEA sweeps a lane
  extern __shared__ __align__(16) unsigned char roll_smem[];
  S* const stages = reinterpret_cast<S*>(roll_smem);
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
    if (nchunks > 0) stage_chunk<L>(a, stages, 0, b0, tid);

  // this lane's feedback rows (lane + m G) mod NU and their box
  int jr[MU];
  S lo[MU], hi[MU];
  for (int m = 0; m < MU; ++m) {
    jr[m] = (lane + m * G) % NU;
    if constexpr (BOXED) {
      lo[m] = a.lb[jr[m] * TB + bc];
      hi[m] = a.ub[jr[m] * TB + bc];
    }
  }
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
  S cost = S(0);

  for (int c = 0; c < nchunks; ++c) {
    if constexpr (kStaged) {
      __pipeline_wait_prior(0);
      __syncthreads();  // chunk c staged; every lane done with chunk c - 1's stage
      if (c + 1 < nchunks)
        stage_chunk<L>(a, stages + ((c + 1) & 1) * L::STAGE, (c + 1) * L::C, b0, tid);
    }
    for (int kk = 0; kk < L::C; ++kk) {
      const int t = c * L::C + kk;
      if (t >= a.T) break;
      const KnotIn<L, S> in{stages + (c & 1) * L::STAGE + kk * L::ROWS * L::P + col, a, t, bc};

      // feedback rows: u_j = u_ref_j - (alpha k_j + K_j dx), clipped
      S dx[NDX];
      for (int i = 0; i < NDX; ++i) dx[i] = x[i] - in.xref(i);
      S um[MU];
      for (int m = 0; m < MU; ++m) {
        S fb = in.kff(jr[m]) * alpha;
        for (int i = 0; i < NDX; ++i) fb = fb + in.Kfb(jr[m], i) * dx[i];
        um[m] = in.uref(jr[m]) - fb;
        if constexpr (BOXED) um[m] = dclip(um[m], lo[m], hi[m]);
        if (live && lane + m * G < NU) us_o[((long long)t * NU + jr[m]) * TB + b] = um[m];
      }
      S u[NU];
      for (int j = 0; j < NU; ++j) u[j] = grp.from(j % G, um[j / G]);

      // the RNEA sweeps of mass_nle, sweep cs on lane cs mod G
      S sw[MS][NL];
      for (int m = 0; m < MS; ++m) {
        const int cs = lane + m * G < NL ? lane + m * G : NL;
        mass_nle_sweep<S, NL>(P, x, x + 2 * NL, cs, sw[m]);
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
        for (int i = 0; i < NDX; ++i) xk[i] = keep ? x[i] : xk[i];
        for (int j = 0; j < NU; ++j) uk[j] = keep ? u[j] : uk[j];
      } else {
        cost = cost + running_cost<S, NL, SEA>(P, x, u);
      }
      euler<S, NL>(P.dt, x, acc, xn);
      for (int i = 0; i < NDX; ++i) {
        x[i] = xn[i];
        if constexpr (GAPS) x[i] = x[i] + in.fs_next(i) * gscale;
        if (live && i % G == lane) xs_o[((long long)(t + 1) * NDX + i) * TB + b] = x[i];
      }
      if constexpr (kDeferCost)
        if (t % G == G - 1) cost = fold(grp, cost, running_cost<S, NL, SEA>(P, xk, uk), G);
    }
  }
  if constexpr (kDeferCost)
    if (a.T % G) cost = fold(grp, cost, running_cost<S, NL, SEA>(P, xk, uk), a.T % G);
  S r6[6];
  const S goal = goal_cost<S, NL>(P, x, true, r6);
  if (live && lane == 0) cost_o[b] = cost + a.wterm[bc] * goal;
}

// two entry kernels over one body, so that a profile tells K3 from K6
template <class S, int NL, bool SEA, bool BOXED, bool GAPS>
__global__ void __launch_bounds__(kRollThreads1) rollout1_kernel(const VSAParams<NL> P,
                                                                const Roll<S> a) {
  rollout_group<S, NL, SEA, BOXED, GAPS, 1>(P, a);
}

template <class S, int NL, bool SEA, bool BOXED, bool GAPS>
__global__ void __launch_bounds__(kRollThreads2) rollout2_kernel(const VSAParams<NL> P,
                                                                const Roll<S> a) {
  rollout_group<S, NL, SEA, BOXED, GAPS, 2>(P, a);
}

template <class S, int NT, bool SEA, bool BOXED, bool GAPS>
static int launch_variant(const VSAParams<2>& P, const Roll<S>& a, cudaStream_t stream) {
  using L = RollLayout<S, Arm<2, SEA>::NDX, Arm<2, SEA>::NU, GAPS, NT>;
  const int grid = (a.B + L::SPB - 1) / L::SPB;
  if constexpr (NT == 1) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        rollout1_kernel<S, 2, SEA, BOXED, GAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    rollout1_kernel<S, 2, SEA, BOXED, GAPS><<<grid, L::THREADS, L::BYTES, stream>>>(P, a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        rollout2_kernel<S, 2, SEA, BOXED, GAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    rollout2_kernel<S, 2, SEA, BOXED, GAPS><<<grid, L::THREADS, L::BYTES, stream>>>(P, a);
  }
  return (int)cudaGetLastError();
}

// ntrials 1 (K6: alpha_b and the b outputs unused) or 2 (K3); lb/ub null:
// no box; fs/infeas null: no gaps
template <class S, int NT>
static int launch_rollout(const double* params, int nl, Roll<S> a, void* stream) {
  if (nl != 2) return -1;
  const VSAParams<2> P = unpack_params<2>(params);
  const void* staged[] = {a.xs, a.us, a.k, a.K, a.fs};
  a.vec = a.B % (16 / (int)sizeof(S)) == 0;
  for (const void* p : staged) a.vec = a.vec && aligned16(p);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((P.sea ? 4 : 0) + (a.lb ? 2 : 0) + (a.fs ? 1 : 0)) {
    case 0: return launch_variant<S, NT, false, false, false>(P, a, st);
    case 1: return launch_variant<S, NT, false, false, true>(P, a, st);
    case 2: return launch_variant<S, NT, false, true, false>(P, a, st);
    case 3: return launch_variant<S, NT, false, true, true>(P, a, st);
    case 4: return launch_variant<S, NT, true, false, false>(P, a, st);
    case 5: return launch_variant<S, NT, true, false, true>(P, a, st);
    case 6: return launch_variant<S, NT, true, true, false>(P, a, st);
    default: return launch_variant<S, NT, true, true, true>(P, a, st);
  }
}

template <class S>
static int roll_bytes(int ntrials, int sea, int gaps) {
  constexpr int NL = 2;
  const int v = (ntrials == 2 ? 4 : 0) + (sea ? 2 : 0) + (gaps ? 1 : 0);
  constexpr int X = Arm<NL, false>::NDX, UV = Arm<NL, false>::NU, US = Arm<NL, true>::NU;
  switch (v) {
    case 0: return (int)RollLayout<S, X, UV, false, 1>::BYTES;
    case 1: return (int)RollLayout<S, X, UV, true, 1>::BYTES;
    case 2: return (int)RollLayout<S, X, US, false, 1>::BYTES;
    case 3: return (int)RollLayout<S, X, US, true, 1>::BYTES;
    case 4: return (int)RollLayout<S, X, UV, false, 2>::BYTES;
    case 5: return (int)RollLayout<S, X, UV, true, 2>::BYTES;
    case 6: return (int)RollLayout<S, X, US, false, 2>::BYTES;
    default: return (int)RollLayout<S, X, US, true, 2>::BYTES;
  }
}

}  // namespace aslr

// the dynamic shared memory of one block of K3 (ntrials 2) or K6 (1), VSA or
// SEA, with or without gaps, for 4- or 8-byte scalars, in bytes
extern "C" int aslr_rollout_smem(int ntrials, int sea, int gaps, int itemsize) {
  if (ntrials != 1 && ntrials != 2) return -1;
  if (itemsize == 4) return aslr::roll_bytes<float>(ntrials, sea, gaps);
  return itemsize == 8 ? aslr::roll_bytes<double>(ntrials, sea, gaps) : -1;
}

#define ASLR_ROLLOUT2_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha_a, const S* alpha_b,         \
                      const S* wterm, const S* lb, const S* ub, const S* fs,               \
                      const S* infeas, int T, int B, S* xs_a, S* us_a, S* cost_a, S* xs_b, \
                      S* us_b, S* cost_b, void* stream) {                                  \
    aslr::Roll<S> a{xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub, fs, infeas,        \
                    T, B, false, xs_a, us_a, cost_a, xs_b, us_b, cost_b};                  \
    return aslr::launch_rollout<S, 2>(params, nl, a, stream);                              \
  }

#define ASLR_ROLLOUT1_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha, const S* wterm,             \
                      const S* lb, const S* ub, const S* fs, const S* infeas, int T, int B, \
                      S* xs_o, S* us_o, S* cost_o, void* stream) {                         \
    aslr::Roll<S> a{xs, us, k, K, x0, alpha, nullptr, wterm, lb, ub, fs, infeas,          \
                    T, B, false, xs_o, us_o, cost_o, nullptr, nullptr, nullptr};           \
    return aslr::launch_rollout<S, 1>(params, nl, a, stream);                              \
  }

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f32, float)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f64, double)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f32, float)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f64, double)
