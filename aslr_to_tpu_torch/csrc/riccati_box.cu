// K2, K4 and K5: the backward Riccati sweeps, one group kernel. Two template
// switches pick the instance: QP (the gains of a masked projected-Newton
// BoxQP, or those of a plain Cholesky of Quu) and GAPS (the FDDP deflection
// and gap sums). K2 (Box-DDP) is QP without GAPS, K5 (BoxFDDP) QP with
// GAPS, K4 (FDDP, and DDP with zero gaps) the Cholesky instance with GAPS.
//
// Replaces the Pallas kernels aslr_to_tpu/pallas/riccati.py::
// _riccati_box_kernel (launched by prepare_riccati_box_backward_lanes, with
// its helpers _boxqp_lanes, _masked_chol_solve, _chol4, _chol4_solve) and
// _riccati_fddp_kernel with boxed=True (launched by
// prepare_riccati_boxfddp_backward_lanes) and boxed=False (launched by
// prepare_riccati_fddp_backward_lanes). Per scenario, over the knots
// T-1 .. 0:
//   Q terms from (Vx, Vxx), Quu + reg I;
//   the gains: K2/K5 a masked projected-Newton BoxQP on the box (lb - u,
//   ub - u), started from -kprev (warm) or 0 (cold), qp_iters iterations,
//   each a masked Cholesky Newton step and a 5-step Armijo search, then the
//   free-subspace gains K from a masked Cholesky; K4 k and K from one
//   Cholesky of Quu;
//   K2/K5's box is the scenario's own (lanes of lb/ub) or, for a per-knot
//   problem (riccati.py::_box_at), knot t's row of [T, nu] tables; a null
//   table pointer picks the former by a uniform branch, so one instance
//   serves both;
//   the value update with symmetrization and reg; with GAPS the deflection
//   w_t = Vxx_t fs_t and Vx += w_t (after the terminal node's own w_T);
//   the sums dg, dq, stop (with GAPS also dg_gap = -sum Vx.fs, dq_gap =
//   sum fs.w) and the flags ok and retryable (a failure whose Quu was still
//   finite).
//
// What bounds it: the instructions each warp issues. The bytes (228-236
// values a knot and scenario with a box, 208 for K4 at nu 2) take
// 0.10-0.14 ms at T=100, B=4096 on an H100; the knot loop is a dependent
// chain per scenario, and the BoxQP inside it a chain of IEEE divisions and
// square roots (up to 54 a knot). The earlier designs (one thread a
// scenario) ran 4096 threads, read every derivative from global memory
// inside the products, solved the eight gain columns one after another
// and spilled in f64. This one:
//   - spreads a scenario over a group of G >= NDX lanes of one warp (G = 8:
//     four scenarios a warp, 16 a block of 128 threads, 256 blocks at
//     B = 4096). Lane r owns row r of Fx^T Vxx, Qx, Qxu and the new Vxx,
//     and column r of the gains K, so the NDX column solves run side by
//     side. Vx, Vxx, the exchanged Q blocks and K sit in the block's shared
//     memory; the group meets at __syncwarp on its own mask and votes with
//     __all_sync / __ballot_sync on that mask, never the whole warp's.
//     Wider groups (16, 32 lanes) run slower: the work every lane of a
//     group repeats (the QP, the Cholesky) then serves fewer scenarios a
//     warp instruction. K4 and K5 at (12, 3) take the next power of two at
//     or above ndx, 16 lanes; the lanes past ndx own no row but meet every
//     barrier, vote and shuffle of their group. K4 and K5 at (28, 7), a
//     whole warp a scenario, have a layout of their own (fddp_sweep_wide,
//     below);
//   - stages each knot's inputs in shared memory with cp.async, coalesced
//     along the batch axis ([rows, scenarios] tiles, 16-byte copies where
//     the batch stride and the pointers allow, else one element a copy),
//     double-buffered: knot t-1's copy is in flight while knot t computes,
//     so no global load sits on the dependent chain. K4 stages no controls,
//     warm start or box. With the box tables, knot t's two rows ride in the
//     same commit into a slot of their own after the scratch (a slot a
//     stage, allocated only when the tables are given);
//   - runs the factor and the solves redundantly on every lane of the group
//     (a SIMT instruction costs the same on one lane or eight); the BoxQP's
//     five Armijo trials on five lanes (accepted in order by a ballot, the
//     winner's point shuffled from its lane), and keeps the masked factor
//     while the free set does not change (boxqp.cuh);
//   - skips the division of a zero dividend in the BoxQP (boxqp.cuh::div0):
//     the clamped controls zero whole rows of the masked systems, and IEEE
//     division sends a zero dividend down its slow path. K4's Cholesky has
//     few zero dividends and divides plainly (kCholSkip0).
// aslr_to_tpu_torch/box_variants.py times each of these choices against
// its alternative on the card.
// The products are 8x8x8 per scenario (28x28x28 at (28, 7)), each
// scenario with its own operands, so no tensor cores: TF32 would cut f32
// precision, and f64 DMMA would change the summation order. Every dot
// product runs in one thread in the order of its plain version
// (aslr_to_tpu_torch/kernels/riccati.py), and the build has -fmad=false,
// so the kernel equals its plain version to the bit; FMA contraction would
// trade that for a tolerance.
//
// The ragged last block keeps its out-of-range groups in every barrier:
// they compute on whatever the stage holds and skip their loads and stores.
#include <cuda_pipeline.h>

#include "boxqp.cuh"

namespace aslr {

template <class S>
struct BoxSweep {
  const S *Fx, *Fu, *Lx, *Lu, *Lxx, *Lxu, *Luu, *tLx, *tLxx, *fs, *us, *kprev, *lb, *ub, *reg;
  const S *lbt, *ubt;  // null, or the [T, NU] box tables in place of lb/ub (row t knot t's)
  int T, B, qp_iters;
  bool vec;  // 16-byte copies: the batch stride and every input pointer allow them
  S *k, *K, *w, *dg, *dq, *stop, *dgg, *dqg;
  bool *ok, *retryable;
};

constexpr int kSweepThreads = 128;
constexpr bool kCholSkip0 = false;  // K4's Cholesky skips zero dividends (boxqp.cuh::div0)

// The block's shared memory: two stages of knot inputs (double-buffered),
// each a [rows, P] tile (P = scenarios a block plus 16 bytes, which spreads
// a warp's scenarios over the banks), then one scratch region a scenario.
template <class S, int NDX, int NU, int G, bool GAPS, bool QP>
struct Sweep {
  static constexpr int SPB = kSweepThreads / G, NSTAGE = 2, NUS = NU;
  // 16-byte copies, or narrower where a block holds fewer scenarios
  static constexpr int VEC = 16 / (int)sizeof(S) < SPB ? 16 / (int)sizeof(S) : SPB;
  static constexpr int P = SPB + VEC;
  static constexpr bool BOXQP = QP;
  static_assert(G >= NDX, "a lane a row");
  static_assert(!QP || G >= 5, "five Armijo trials, a lane each");
  static_assert(SPB % VEC == 0, "16-byte copies tile the scenarios of a block");
  // stage rows, per knot and scenario (the controls and the warm start only
  // for the BoxQP)
  static constexpr int rFx = 0, rFu = rFx + NDX * NDX, rLx = rFu + NDX * NU, rLu = rLx + NDX,
                       rLxx = rLu + NU, rLxu = rLxx + NDX * NDX, rLuu = rLxu + NDX * NU,
                       rUs = rLuu + NU * NU, rKp = rUs + (QP ? NU : 0), rFs = rKp + (QP ? NU : 0),
                       ROWS = rFs + (GAPS ? NDX : 0), STAGE = ROWS * P;
  // scratch, per scenario: Vxx (column r written by lane r), Vx, w, the
  // exchanged FuTVxx (then the unsymmetrized V), Qu, Quu and K
  static constexpr int oVxx = 0, oVx = NDX * NDX, oW = oVx + NDX, oX = oW + NDX,
                       oQu = oX + NDX * NDX, oQuu = oQu + NU, oK = oQuu + NU * NU,
                       USED = oK + NU * NDX;
  static constexpr int SC = (USED + 31) / 32 * 32 + 8;  // four scenarios of a warp, 8 banks apart
  static constexpr size_t BYTES = (size_t)(NSTAGE * STAGE + SPB * SC) * sizeof(S);
  // after the scratch, where the box tables are given: each stage's knot's
  // rows of them (lb, then ub), copied with the stage
  static constexpr int oBox = NSTAGE * STAGE + SPB * SC;
  static constexpr size_t BOX_BYTES = QP ? (size_t)NSTAGE * 2 * NU * sizeof(S) : 0;
  static constexpr bool FITS = BYTES + BOX_BYTES <= kMaxSmem;
};

// lanes a scenario: lane r owns row r, so the next power of two at or above
// ndx (8, 16 and 32 at ndx 8, 12 and 28; lanes past ndx own no row)
template <int NDX>
constexpr int kSweepGroup = pow2_at_least(NDX);

// copy knot t of an array [T, rows, B] into a stage tile [rows, P], the
// block's scenarios b0 .. b0 + SPB, V elements a copy
template <class L, int V, class S>
__device__ inline void stage_rows(S* dst, const S* src, int rows, long long t, long long TB,
                                  int b0, int tid) {
  constexpr int CPR = L::SPB / V;
  const S* base = src + t * rows * TB + b0;
  for (int c = tid; c < rows * CPR; c += kSweepThreads) {
    const int row = c / CPR, s0 = (c % CPR) * V;
    if (b0 + s0 < TB)
      __pipeline_memcpy_async(dst + row * L::P + s0, base + row * TB + s0, V * sizeof(S));
  }
}

template <class L, int V, class S>
__device__ inline void stage_knot(const BoxSweep<S>& a, S* dst, long long t, int b0, int tid) {
  const long long TB = a.B;
  stage_rows<L, V>(dst + L::rFx * L::P, a.Fx, L::rFu - L::rFx, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rFu * L::P, a.Fu, L::rLx - L::rFu, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rLx * L::P, a.Lx, L::rLu - L::rLx, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rLu * L::P, a.Lu, L::rLxx - L::rLu, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rLxx * L::P, a.Lxx, L::rLxu - L::rLxx, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rLxu * L::P, a.Lxu, L::rLuu - L::rLxu, t, TB, b0, tid);
  stage_rows<L, V>(dst + L::rLuu * L::P, a.Luu, L::rUs - L::rLuu, t, TB, b0, tid);
  if constexpr (L::BOXQP) {
    stage_rows<L, V>(dst + L::rUs * L::P, a.us, L::rKp - L::rUs, t, TB, b0, tid);
    if (a.kprev) stage_rows<L, V>(dst + L::rKp * L::P, a.kprev, L::rFs - L::rKp, t, TB, b0, tid);
  }
  if constexpr (L::ROWS > L::rFs)
    stage_rows<L, V>(dst + L::rFs * L::P, a.fs, L::ROWS - L::rFs, t, TB, b0, tid);
}

// knot t into a stage (and, with the box tables, its rows into the
// stage's box slot), as one commit
template <class L, class S>
__device__ inline void stage(const BoxSweep<S>& a, S* stages, long long t, int b0, int tid) {
  S* const dst = stages + (t % L::NSTAGE) * L::STAGE;
  if (a.vec) stage_knot<L, L::VEC>(a, dst, t, b0, tid);
  else stage_knot<L, 1>(a, dst, t, b0, tid);
  if constexpr (L::BOXQP) {
    if (a.lbt && tid < 2 * L::NUS) {
      const S* src = tid < L::NUS ? a.lbt + t * L::NUS + tid
                                    : a.ubt + t * L::NUS + (tid - L::NUS);
      __pipeline_memcpy_async(stages + L::oBox + (t % L::NSTAGE) * 2 * L::NUS + tid, src,
                              sizeof(S));
    }
  }
  __pipeline_commit();
}

template <class S, int NDX, int NU, int G, bool GAPS, bool QP>
__device__ inline void box_sweep(const BoxSweep<S>& a) {
  using L = Sweep<S, NDX, NU, G, GAPS, QP>;
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  S* const stages = reinterpret_cast<S*>(sweep_smem);
  const int tid = threadIdx.x, s = tid / G;
  const Group<G> grp;
  const int r = grp.lane < NDX ? grp.lane : NDX - 1;  // lanes past NDX repeat the last row
  const bool own = grp.lane < NDX;
  const int b0 = blockIdx.x * L::SPB;
  const long long TB = a.B, b = b0 + s;
  const bool live = b < TB;
  const long long bc = live ? b : TB - 1;  // where an out-of-range group reads
  S* const my = stages + L::NSTAGE * L::STAGE + s * L::SC;
  S *const vxx = my + L::oVxx, *const vx = my + L::oVx, *const ws = my + L::oW;
  S *const xs = my + L::oX, *const qus = my + L::oQu, *const quus = my + L::oQuu;
  S* const ks = my + L::oK;

  if (a.T > 0) stage<L>(a, stages, a.T - 1, b0, tid);

  const S reg = a.reg[bc];
  // the scenario's box (lanes of lb/ub), unless the tables give each knot's
  S lo[NU], hi[NU];
  if constexpr (QP)
    if (!a.lbt)
      for (int j = 0; j < NU; ++j) {
        lo[j] = a.lb[j * TB + bc];
        hi[j] = a.ub[j * TB + bc];
      }
  // terminal node: Vxx = tLxx + reg I (row r, stored as given: tLxx need
  // not be symmetric), Vx = tLx (K5: + w_T, w_T = Vxx fs_T)
  S vrow[NDX];
  for (int m = 0; m < NDX; ++m) {
    vrow[m] = a.tLxx[(r * NDX + m) * TB + bc];
    if (m == r) vrow[m] = vrow[m] + reg;
  }
  S vx_r = a.tLx[r * TB + bc];
  if constexpr (GAPS) {
    S acc = vrow[0] * a.fs[((long long)a.T * NDX) * TB + bc];
    for (int j = 1; j < NDX; ++j) acc = acc + vrow[j] * a.fs[((long long)a.T * NDX + j) * TB + bc];
    vx_r = vx_r + acc;
    if (own) ws[r] = acc;
    if (own && live) a.w[((long long)a.T * NDX + r) * TB + b] = acc;
  }
  if (own) {
    vx[r] = vx_r;
    for (int m = 0; m < NDX; ++m) vxx[r * NDX + m] = vrow[m];
  }
  S dg = S(0), dq = S(0), stop = S(0), dgg = S(0), dqg = S(0);
  grp.sync();
  if constexpr (GAPS) {
    S s1 = vx[0] * a.fs[((long long)a.T * NDX) * TB + bc];
    S s2 = a.fs[((long long)a.T * NDX) * TB + bc] * ws[0];
    for (int i = 1; i < NDX; ++i) {
      const S f = a.fs[((long long)a.T * NDX + i) * TB + bc];
      s1 = s1 + vx[i] * f;
      s2 = s2 + f * ws[i];
    }
    dgg = -s1;
    dqg = s2;
  }
  bool indef = false;

  for (int t = a.T - 1; t >= 0; --t) {
    __pipeline_wait_prior(0);
    __syncthreads();  // knot t staged; every lane done with knot t+1's stage
    if (t > 0) stage<L>(a, stages, t - 1, b0, tid);
    const S* const st = stages + (t % L::NSTAGE) * L::STAGE + s;
    auto in = [&](int row) { return st[row * L::P]; };
    const long long kt = t;

    // Qx[r] = Lx + Fx^T Vx; Qu = Lu + Fu^T Vx (entry lane % NU)
    S Vx[NDX];
    for (int m = 0; m < NDX; ++m) Vx[m] = vx[m];
    S qx;
    {
      S acc = in(L::rFx + r) * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + in(L::rFx + m * NDX + r) * Vx[m];
      qx = in(L::rLx + r) + acc;
    }
    {
      const int j = grp.lane % NU;
      S acc = in(L::rFu + j) * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + in(L::rFu + m * NU + j) * Vx[m];
      if (grp.lane < NU) qus[j] = in(L::rLu + j) + acc;
    }
    // row r of FxTVxx = Fx^T Vxx; column r of FuTVxx = Fu^T Vxx (exchanged)
    S ftv[NDX];
    {
      S fxc[NDX];
      for (int i = 0; i < NDX; ++i) fxc[i] = in(L::rFx + i * NDX + r);
      for (int m = 0; m < NDX; ++m) {
        S acc = fxc[0] * vxx[m];
        for (int i = 1; i < NDX; ++i) acc = acc + fxc[i] * vxx[i * NDX + m];
        ftv[m] = acc;
      }
    }
    for (int j = 0; j < NU; ++j) {
      S acc = in(L::rFu + j) * vxx[r];
      for (int i = 1; i < NDX; ++i) acc = acc + in(L::rFu + i * NU + j) * vxx[i * NDX + r];
      if (own) xs[j * NDX + r] = acc;
    }
    // row r of Qxu = Lxu + FxTVxx Fu, and of Qxx = Lxx + FxTVxx Fx
    S qxu[NU], qxx[NDX];
    for (int m = 0; m < NU; ++m) {
      S acc = ftv[0] * in(L::rFu + m);
      for (int i = 1; i < NDX; ++i) acc = acc + ftv[i] * in(L::rFu + i * NU + m);
      qxu[m] = in(L::rLxu + r * NU + m) + acc;
    }
    for (int m = 0; m < NDX; ++m) {
      S acc = ftv[0] * in(L::rFx + m);
      for (int i = 1; i < NDX; ++i) acc = acc + ftv[i] * in(L::rFx + i * NDX + m);
      qxx[m] = in(L::rLxx + r * NDX + m) + acc;
    }
    grp.sync();
    // Quu = Luu + FuTVxx Fu + reg I, its entries spread over the lanes
    for (int e = grp.lane; e < NU * NU; e += G) {
      const int i = e / NU, j = e % NU;
      S acc = xs[i * NDX] * in(L::rFu + j);
      for (int m = 1; m < NDX; ++m) acc = acc + xs[i * NDX + m] * in(L::rFu + m * NU + j);
      S v = in(L::rLuu + e) + acc;
      if (i == j) v = v + reg;
      quus[e] = v;
    }
    grp.sync();
    S Quu[NU][NU], Qu[NU];
    bool quu_ok = true;
    for (int i = 0; i < NU; ++i) {
      Qu[i] = qus[i];
      for (int j = 0; j < NU; ++j) {
        Quu[i][j] = quus[i * NU + j];
        quu_ok = quu_ok && finite(Quu[i][j]);
      }
    }

    S k[NU], kc[NU];
    if constexpr (QP) {
      // box QP on du in (lb - u, ub - u), warm-started from -kprev; knot t's
      // box from its stage's rows of the tables (a uniform branch)
      const S* const bx = stages + L::oBox + (t % L::NSTAGE) * 2 * NU;
      S low[NU], up[NU], du[NU], free[NU];
      for (int j = 0; j < NU; ++j) {
        const S u_t = in(L::rUs + j);
        low[j] = (a.lbt ? bx[j] : lo[j]) - u_t;
        up[j] = (a.lbt ? bx[NU + j] : hi[j]) - u_t;
        du[j] = a.kprev ? -in(L::rKp + j) : S(0);
      }
      S Lf[NU][NU];
      boxqp_group<S, NU>(grp, Quu, Qu, low, up, a.qp_iters, du, free, Lf);
      for (int j = 0; j < NU; ++j) k[j] = -du[j];
      // column r of the free-subspace gains: masked solve with row r of Qxu
      S rhs[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = qxu[i] * free[i];
      chol_solve<S, NU, true>(Lf, rhs, kc);
    } else {
      // k = Quu^-1 Qu; column r of K = Quu^-1 (row r of Qxu)
      S Lf[NU][NU];
      chol<S, NU, kCholSkip0>(Quu, Lf);
      chol_solve<S, NU, kCholSkip0>(Lf, Qu, k);
      chol_solve<S, NU, kCholSkip0>(Lf, qxu, kc);
    }
    if (own)
      for (int i = 0; i < NU; ++i) ks[i * NDX + r] = kc[i];

    // Vx[r] = Qx + K^T Quu k - 2 K^T Qu
    S Quuk[NU];
    for (int i = 0; i < NU; ++i) {
      S acc = Quu[i][0] * k[0];
      for (int j = 1; j < NU; ++j) acc = acc + Quu[i][j] * k[j];
      Quuk[i] = acc;
    }
    bool out_ok = true;
    for (int j = 0; j < NU; ++j) out_ok = out_ok && finite(k[j]) && finite(kc[j]);
    {
      S a1 = kc[0] * Quuk[0], a2 = kc[0] * Qu[0];
      for (int i = 1; i < NU; ++i) {
        a1 = a1 + kc[i] * Quuk[i];
        a2 = a2 + kc[i] * Qu[i];
      }
      vx_r = qx + a1 - S(2) * a2;
    }
    grp.sync();
    // row r of V = Qxx - Qxu K (into the exchange, which FuTVxx has left)
    for (int m = 0; m < NDX; ++m) {
      S qk = qxu[0] * ks[m];
      for (int i = 1; i < NU; ++i) qk = qk + qxu[i] * ks[i * NDX + m];
      vrow[m] = qxx[m] - qk;
      if (own) xs[m * NDX + r] = vrow[m];
    }
    grp.sync();
    // Vxx = sym(V) + reg I; row r equals column r, which lane r stores
    for (int m = 0; m < NDX; ++m) {
      S v = S(0.5) * (vrow[m] + xs[r * NDX + m]);
      if (m == r) v = v + reg;
      vrow[m] = v;
      out_ok = out_ok && finite(v);
    }
    S w_r = S(0);
    if constexpr (GAPS) {  // deflection w_t = Vxx_t fs_t; Vx += w_t
      S acc = vrow[0] * in(L::rFs);
      for (int j = 1; j < NDX; ++j) acc = acc + vrow[j] * in(L::rFs + j);
      w_r = acc;
      vx_r = vx_r + acc;
    }
    out_ok = out_ok && finite(vx_r);
    if (own) {
      vx[r] = vx_r;
      if (GAPS) ws[r] = w_r;
      for (int m = 0; m < NDX; ++m) vxx[m * NDX + r] = vrow[m];
    }
    out_ok = grp.all(out_ok);
    indef = indef || (quu_ok && !out_ok);

    if (live) {
      for (int j = 0; j < NU; ++j)
        if (grp.lane == j) a.k[(kt * NU + j) * TB + b] = k[j];
      if (own) {
        for (int i = 0; i < NU; ++i) a.K[((kt * NU + i) * NDX + r) * TB + b] = kc[i];
        if (GAPS) a.w[(kt * NDX + r) * TB + b] = w_r;
      }
    }
    S sg = Qu[0] * k[0], sq = k[0] * Quuk[0], ss = Qu[0] * Qu[0];
    for (int j = 1; j < NU; ++j) {
      sg = sg + Qu[j] * k[j];
      sq = sq + k[j] * Quuk[j];
      ss = ss + Qu[j] * Qu[j];
    }
    dg = dg + sg;
    dq = dq - sq;
    stop = stop + ss;
    if constexpr (GAPS) {
      grp.sync();
      S s1 = vx[0] * in(L::rFs), s2 = in(L::rFs) * ws[0];
      for (int i = 1; i < NDX; ++i) {
        s1 = s1 + vx[i] * in(L::rFs + i);
        s2 = s2 + in(L::rFs + i) * ws[i];
      }
      dgg = dgg - s1;
      dqg = dqg + s2;
    }
  }
  grp.sync();
  bool ok = finite(dg) && finite(stop) && (GAPS || finite(dq));
  for (int i = 0; i < NDX; ++i) ok = ok && finite(vx[i]);
  if (live && grp.lane == 0) {
    a.dg[b] = dg;
    a.dq[b] = dq;
    a.stop[b] = stop;
    if (GAPS) {
      a.dgg[b] = dgg;
      a.dqg[b] = dqg;
    }
    a.ok[b] = ok;
    a.retryable[b] = indef;
  }
}

// K4 and K5 above ndx 16 (the 7-DoF arm's (28, 7)): the wide layout. A scenario
// is a whole warp there (lane r row r, lanes past ndx repeat the last),
// and the general layout's [rows, scenarios] tile served it badly: a lane
// reading its own row (Lxx, Lxu, the exchanged V) or column (Fx) strides
// the tile by whole rows, so its 28 lanes met in a few banks (28-way on
// Lxx), every row that all lanes read (Fx, Fu, Vxx, K) took one load an
// element, and the 16-byte padding that spread four scenarios of a warp
// over the banks doubled a tile that let only one block of four scenarios
// on an SM (B = 1024 in two waves). Here each scenario's knot is a
// contiguous tile of its own (its sections one after another, each on a
// 16-byte boundary), so
//   - a row every lane reads is a broadcast;
//   - a lane's own row of Lxx and of the exchanged V strides the tile by
//     28 words a lane, so each f32 read meets four lanes a bank (the
//     general layout's 28), its column of Fx is a run of consecutive words
//     and its row of Lxu a stride of 7 words: no conflict (16-byte loads
//     of those rows ran within 1.5% of these, PERF.md);
//   - the tile pitch is 32 bytes past a multiple of 128, so the element
//     copies that stage it (four scenarios of eight rows a warp) write 32
//     different banks; the knot's copy is in flight while the knot before
//     computes, in f64 too: two stages and the scratch take 96,896 bytes
//     in f32 (two blocks an SM: every scenario of B = 1024 in one wave)
//     and 193,472 in f64;
//   - the row loops run 16 bytes of outputs at a time (rows_dot), so only
//     their sums are live, and in f64 a lane's row of Qxx waits out the
//     factor and solves in the exchange (PARK), where its 56 registers
//     would spill.
// box_variants.py --shape 28x7 times each choice against its alternative
// (K4's). K5 there (QP): the tile gains the knot's controls and warm start,
// the scratch the scenario's box; the BoxQP runs on the group of 32 lanes
// (boxqp_group: lanes 0-4 the Armijo trials) on Quu read from the exchange,
// not from 49 registers a lane, and the row of Qxx is parked in f32 too:
// the factor and the QP's iterates hold about 100 values a lane. In the
// general layout K5 would not fit: two stages of its 2,086 rows and four
// scratch regions come to about 164 KB a block in f32 and 261 KB in f64.
constexpr int kWideNdx = 16;        // K4 and K5 above this ndx take the wide layout
constexpr int kWideThreads = 128;   // a block of the wide layout: a warp a scenario

// n values of `size` bytes rounded up to whole 16 bytes, in values
constexpr int up16(int n, int size) { return (n * size + 15) / 16 * 16 / size; }
// the least pitch of at least n values of `size` bytes that is 32 bytes
// past a multiple of 128
constexpr int spread128(int n, int size) { return ((n * size + 95) / 128 * 128 + 32) / size; }

template <class S, int NDX_, int NU_, bool QP_ = false>
struct WideSweep {
  static constexpr int NDX = NDX_, NU = NU_, G = 32, THREADS = kWideThreads,
                       SPB = THREADS / G, VEC = 16 / (int)sizeof(S), Z = (int)sizeof(S);
  static constexpr bool QP = QP_;
  // a scenario's knot tile: its sections, each on a 16-byte boundary (K5:
  // then the controls and the warm start)
  static constexpr int rFx = 0, rFu = rFx + up16(NDX * NDX, Z), rLxx = rFu + up16(NDX * NU, Z),
                       rLxu = rLxx + up16(NDX * NDX, Z), rLuu = rLxu + up16(NDX * NU, Z),
                       rLx = rLuu + up16(NU * NU, Z), rFs = rLx + up16(NDX, Z),
                       rLu = rFs + up16(NDX, Z), rUs = rLu + up16(NU, Z),
                       rKp = rUs + (QP ? up16(NU, Z) : 0), ROWS = rKp + (QP ? up16(NU, Z) : 0);
  static constexpr int PITCH = spread128(ROWS, Z), STAGE = SPB * PITCH;
  // scratch, per scenario: as the general layout's, each on a 16-byte
  // boundary (K5: then the box, lb and ub)
  static constexpr int oVxx = 0, oVx = up16(NDX * NDX, Z), oW = oVx + up16(NDX, Z),
                       oX = oW + up16(NDX, Z), oQu = oX + up16(NDX * NDX, Z),
                       oQuu = oQu + up16(NU, Z), oK = oQuu + up16(NU * NU, Z),
                       oBx = oK + up16(NU * NDX, Z), SC = oBx + (QP ? up16(2 * NU, Z) : 0);
  static constexpr size_t BYTES = (size_t)(2 * STAGE + SPB * SC) * sizeof(S);
  static_assert(NDX <= G && NDX % VEC == 0, "a warp a scenario; rows of whole 16 bytes");
  static_assert(PITCH * sizeof(S) % 128 == 32, "the copies spread over the banks");
};

// out[m] (m < N, N a multiple of the values in 16 bytes) = the sum over
// rows i < R of x[i] rows[i * N + m], each sum from i = 0 up as the plain
// version's dot products; 16 bytes of the outputs at a time, so that only
// their sums are live
template <int R, int N, class S>
__device__ inline void rows_dot(const S* x, const S* rows, S* out) {
  constexpr int V = 16 / (int)sizeof(S);
  static_assert(N % V == 0, "rows of whole 16-byte runs of outputs");
#pragma unroll
  for (int m0 = 0; m0 < N; m0 += V) {
    S acc[V];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const S v = rows[i * N + m0 + q];
        acc[q] = i == 0 ? x[0] * v : acc[q] + x[i] * v;
      }
#pragma unroll
    for (int q = 0; q < V; ++q) out[m0 + q] = acc[q];
  }
}

// f(e, p[e]) for e = 0 .. N - 1, in order
template <int N, class S, class F>
__device__ inline void each(const S* p, F f) {
#pragma unroll
  for (int e = 0; e < N; ++e) f(e, p[e]);
}

// knot t of every input into the scenarios' tiles of one stage, an element
// a copy: thread tid copies scenario tid mod SPB's rows tid / SPB + 32 k of
// each section
template <class L, class S>
__device__ inline void wide_rows(S* dst, const S* src, int rows, long long t, long long TB,
                                 int b0, int tid) {
  constexpr int RPT = L::THREADS / L::SPB;  // rows a pass
  const int s = tid % L::SPB;
  if (b0 + s >= TB) return;
  const S* base = src + t * rows * TB + b0 + s;
  S* const d = dst + s * L::PITCH;
  for (int row = tid / L::SPB; row < rows; row += RPT)
    __pipeline_memcpy_async(d + row, base + row * TB, sizeof(S));
}

template <class L, class S>
__device__ inline void wide_stage(const BoxSweep<S>& a, S* stages, long long t, int b0,
                                  int tid) {
  constexpr int NDX = L::NDX, NU = L::NU;
  S* const dst = stages + (t & 1) * L::STAGE;
  const long long TB = a.B;
  wide_rows<L>(dst + L::rFx, a.Fx, NDX * NDX, t, TB, b0, tid);
  wide_rows<L>(dst + L::rFu, a.Fu, NDX * NU, t, TB, b0, tid);
  wide_rows<L>(dst + L::rLxx, a.Lxx, NDX * NDX, t, TB, b0, tid);
  wide_rows<L>(dst + L::rLxu, a.Lxu, NDX * NU, t, TB, b0, tid);
  wide_rows<L>(dst + L::rLuu, a.Luu, NU * NU, t, TB, b0, tid);
  wide_rows<L>(dst + L::rLx, a.Lx, NDX, t, TB, b0, tid);
  wide_rows<L>(dst + L::rFs, a.fs, NDX, t, TB, b0, tid);
  wide_rows<L>(dst + L::rLu, a.Lu, NU, t, TB, b0, tid);
  if constexpr (L::QP) {
    wide_rows<L>(dst + L::rUs, a.us, NU, t, TB, b0, tid);
    if (a.kprev) wide_rows<L>(dst + L::rKp, a.kprev, NU, t, TB, b0, tid);
  }
  __pipeline_commit();
}

// K4 (QP false) and K5 (QP) in the wide layout: the values and the order
// of every sum as box_sweep's instances with gaps (and their plain
// versions')
template <class S, int NDX, int NU, bool QP>
__device__ inline void fddp_sweep_wide(const BoxSweep<S>& a) {
  using L = WideSweep<S, NDX, NU, QP>;
  constexpr int G = L::G;
  // row r of Qxx waits out the factor in shared memory in f64, where its
  // 56 registers would spill, and in K5's QP in f32 too
  constexpr bool PARK = sizeof(S) == 8 || QP;
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  S* const stages = reinterpret_cast<S*>(sweep_smem);
  const int tid = threadIdx.x, s = tid / G;
  const Group<G> grp;
  const int r = grp.lane < NDX ? grp.lane : NDX - 1;  // lanes past NDX repeat the last row
  const bool own = grp.lane < NDX;
  const int b0 = blockIdx.x * L::SPB;
  const long long TB = a.B, b = b0 + s;
  const bool live = b < TB;
  const long long bc = live ? b : TB - 1;  // where an out-of-range warp reads
  S* const my = stages + 2 * L::STAGE + s * L::SC;
  S *const vxx = my + L::oVxx, *const vx = my + L::oVx, *const ws = my + L::oW;
  S *const xs = my + L::oX, *const qus = my + L::oQu, *const quus = my + L::oQuu;
  S* const ks = my + L::oK;
  S* const bx = my + L::oBx;  // K5: the scenario's box, lb then ub

  if (a.T > 0) wide_stage<L>(a, stages, a.T - 1, b0, tid);

  const S reg = a.reg[bc];
  if constexpr (QP)
    if (grp.lane < NU) {
      bx[grp.lane] = a.lb[grp.lane * TB + bc];
      bx[NU + grp.lane] = a.ub[grp.lane * TB + bc];
    }
  // terminal node: Vxx = tLxx + reg I (row r), Vx = tLx + w_T, w_T = Vxx fs_T
  S vrow[NDX];
  for (int m = 0; m < NDX; ++m) {
    vrow[m] = a.tLxx[(r * NDX + m) * TB + bc];
    if (m == r) vrow[m] = vrow[m] + reg;
  }
  S vx_r = a.tLx[r * TB + bc];
  {
    S acc = vrow[0] * a.fs[((long long)a.T * NDX) * TB + bc];
    for (int j = 1; j < NDX; ++j) acc = acc + vrow[j] * a.fs[((long long)a.T * NDX + j) * TB + bc];
    vx_r = vx_r + acc;
    if (own) ws[r] = acc;
    if (own && live) a.w[((long long)a.T * NDX + r) * TB + b] = acc;
  }
  if (own) {
    vx[r] = vx_r;
    for (int m = 0; m < NDX; ++m) vxx[r * NDX + m] = vrow[m];
  }
  S dg = S(0), dq = S(0), stop = S(0), dgg = S(0), dqg = S(0);
  grp.sync();
  {
    S s1 = vx[0] * a.fs[((long long)a.T * NDX) * TB + bc];
    S s2 = a.fs[((long long)a.T * NDX) * TB + bc] * ws[0];
    for (int i = 1; i < NDX; ++i) {
      const S f = a.fs[((long long)a.T * NDX + i) * TB + bc];
      s1 = s1 + vx[i] * f;
      s2 = s2 + f * ws[i];
    }
    dgg = -s1;
    dqg = s2;
  }
  bool indef = false;

  for (int t = a.T - 1; t >= 0; --t) {
    __pipeline_wait_prior(0);
    __syncthreads();  // knot t staged; every lane done with knot t+1's stage
    if (t > 0) wide_stage<L>(a, stages, t - 1, b0, tid);
    const S* const in = stages + (t & 1) * L::STAGE + s * L::PITCH;
    const S* const Fx = in + L::rFx;
    const S* const Fu = in + L::rFu;
    const long long kt = t;

    // column r of Fx; Qx[r] = Lx + Fx^T Vx; Qu = Lu + Fu^T Vx (entry lane % NU)
    S fxc[NDX], Vx[NDX];
    for (int i = 0; i < NDX; ++i) fxc[i] = Fx[i * NDX + r];
    each<NDX>(vx, [&](int m, S v) { Vx[m] = v; });
    S qx;
    {
      S acc = fxc[0] * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + fxc[m] * Vx[m];
      qx = in[L::rLx + r] + acc;
    }
    {
      const int j = grp.lane % NU;
      S acc = Fu[j] * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + Fu[m * NU + j] * Vx[m];
      if (grp.lane < NU) qus[j] = in[L::rLu + j] + acc;
    }
    // row r of FxTVxx = Fx^T Vxx
    S ftv[NDX];
    rows_dot<NDX, NDX>(fxc, vxx, ftv);
    // column r of FuTVxx = Fu^T Vxx (exchanged) and row r of Qxu = Lxu +
    // FxTVxx Fu, Fu row by row
    S fvc[NU], qxu[NU];
    S vc = S(0);
    each<NDX * NU>(Fu, [&](int e, S f) {
      const int i = e / NU, j = e % NU;
      if (j == 0) vc = vxx[i * NDX + r];
      fvc[j] = i == 0 ? f * vc : fvc[j] + f * vc;
      qxu[j] = i == 0 ? ftv[0] * f : qxu[j] + ftv[i] * f;
    });
    for (int j = 0; j < NU; ++j) {
      if (own) xs[j * NDX + r] = fvc[j];
      qxu[j] = in[L::rLxu + r * NU + j] + qxu[j];
    }
    // row r of Qxx = Lxx + FxTVxx Fx
    S qxx[NDX];
    rows_dot<NDX, NDX>(ftv, Fx, qxx);
    each<NDX>(in + L::rLxx + r * NDX, [&](int m, S l) { qxx[m] = l + qxx[m]; });
    grp.sync();
    // Quu = Luu + FuTVxx Fu + reg I, its entries spread over the lanes
    for (int e = grp.lane; e < NU * NU; e += G) {
      const int i = e / NU, j = e % NU;
      S acc = xs[i * NDX] * Fu[j];
      for (int m = 1; m < NDX; ++m) acc = acc + xs[i * NDX + m] * Fu[m * NU + j];
      S v = in[L::rLuu + e] + acc;
      if (i == j) v = v + reg;
      quus[e] = v;
    }
    grp.sync();
    // row r of Qxx, not needed before V, parked in the exchange (column r)
    // while the factor and solves take the registers
    if (PARK && own)
      for (int m = 0; m < NDX; ++m) xs[m * NDX + r] = qxx[m];
    S Qu[NU];
    bool quu_ok = true;
    each<NU>(qus, [&](int i, S v) { Qu[i] = v; });

    S k[NU], kc[NU];
    if constexpr (QP) {
      // box QP on du in (lb - u, ub - u), warm-started from -kprev, on Quu
      // in the exchange; column r of the free-subspace gains: masked solve
      // with row r of Qxu
      const S(&H)[NU][NU] = *reinterpret_cast<const S(*)[NU][NU]>(quus);
      each<NU * NU>(quus, [&](int, S v) { quu_ok = quu_ok && finite(v); });
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
    } else {
      // k = Quu^-1 Qu; column r of K = Quu^-1 (row r of Qxu)
      S Quu[NU][NU], Lf[NU][NU];
      each<NU * NU>(quus, [&](int e, S v) {
        Quu[e / NU][e % NU] = v;
        quu_ok = quu_ok && finite(v);
      });
      chol<S, NU, kCholSkip0>(Quu, Lf);
      chol_solve<S, NU, kCholSkip0>(Lf, Qu, k);
      chol_solve<S, NU, kCholSkip0>(Lf, qxu, kc);
    }
    if (own)
      for (int i = 0; i < NU; ++i) ks[i * NDX + r] = kc[i];

    // Vx[r] = Qx + K^T Quu k - 2 K^T Qu (Quu read again from the exchange)
    S Quuk[NU];
    each<NU * NU>(quus, [&](int e, S v) {
      const int i = e / NU, j = e % NU;
      Quuk[i] = j == 0 ? v * k[0] : Quuk[i] + v * k[j];
    });
    bool out_ok = true;
    for (int j = 0; j < NU; ++j) out_ok = out_ok && finite(k[j]) && finite(kc[j]);
    {
      S a1 = kc[0] * Quuk[0], a2 = kc[0] * Qu[0];
      for (int i = 1; i < NU; ++i) {
        a1 = a1 + kc[i] * Quuk[i];
        a2 = a2 + kc[i] * Qu[i];
      }
      vx_r = qx + a1 - S(2) * a2;
    }
    grp.sync();
    // row r of V = Qxx - Qxu K (into the exchange, which FuTVxx has left);
    // every lane reads its parked row before any lane writes V over it
    if constexpr (PARK) {
      for (int m = 0; m < NDX; ++m) qxx[m] = xs[m * NDX + r];
      grp.sync();
    }
    rows_dot<NU, NDX>(qxu, ks, vrow);
    for (int m = 0; m < NDX; ++m) {
      vrow[m] = qxx[m] - vrow[m];
      if (own) xs[m * NDX + r] = vrow[m];
    }
    grp.sync();
    // Vxx = sym(V) + reg I; row r equals column r, which lane r stores
    each<NDX>(xs + r * NDX, [&](int m, S v) {
      S w = S(0.5) * (vrow[m] + v);
      if (m == r) w = w + reg;
      vrow[m] = w;
      out_ok = out_ok && finite(w);
    });
    S fsn[NDX];
    each<NDX>(in + L::rFs, [&](int j, S v) { fsn[j] = v; });
    S w_r;
    {  // deflection w_t = Vxx_t fs_t; Vx += w_t
      S acc = vrow[0] * fsn[0];
      for (int j = 1; j < NDX; ++j) acc = acc + vrow[j] * fsn[j];
      w_r = acc;
      vx_r = vx_r + acc;
    }
    out_ok = out_ok && finite(vx_r);
    if (own) {
      vx[r] = vx_r;
      ws[r] = w_r;
      for (int m = 0; m < NDX; ++m) vxx[m * NDX + r] = vrow[m];
    }
    out_ok = grp.all(out_ok);
    indef = indef || (quu_ok && !out_ok);

    if (live) {
      for (int j = 0; j < NU; ++j)
        if (grp.lane == j) a.k[(kt * NU + j) * TB + b] = k[j];
      if (own) {
        for (int i = 0; i < NU; ++i) a.K[((kt * NU + i) * NDX + r) * TB + b] = kc[i];
        a.w[(kt * NDX + r) * TB + b] = w_r;
      }
    }
    S sg = Qu[0] * k[0], sq = k[0] * Quuk[0], ss = Qu[0] * Qu[0];
    for (int j = 1; j < NU; ++j) {
      sg = sg + Qu[j] * k[j];
      sq = sq + k[j] * Quuk[j];
      ss = ss + Qu[j] * Qu[j];
    }
    dg = dg + sg;
    dq = dq - sq;
    stop = stop + ss;
    grp.sync();
    {
      S s1 = S(0), s2 = S(0);
      each<NDX>(vx, [&](int i, S v) { s1 = i == 0 ? v * fsn[0] : s1 + v * fsn[i]; });
      each<NDX>(ws, [&](int i, S v) { s2 = i == 0 ? fsn[0] * v : s2 + fsn[i] * v; });
      dgg = dgg - s1;
      dqg = dqg + s2;
    }
  }
  grp.sync();
  bool ok = finite(dg) && finite(stop);
  for (int i = 0; i < NDX; ++i) ok = ok && finite(vx[i]);
  if (live && grp.lane == 0) {
    a.dg[b] = dg;
    a.dq[b] = dq;
    a.stop[b] = stop;
    a.dgg[b] = dgg;
    a.dqg[b] = dqg;
    a.ok[b] = ok;
    a.retryable[b] = indef;
  }
}

// three entry kernels over one body, so that a profile tells K2, K4 and K5
// apart
template <class S, int NDX, int NU, int G>
__global__ void __launch_bounds__(kSweepThreads) riccati_box_kernel(const BoxSweep<S> a) {
  box_sweep<S, NDX, NU, G, false, true>(a);
}

// K4's and K5's block: the wide layout's above kWideNdx, else the general
// one's
template <int NDX>
constexpr int kFddpThreads = NDX > kWideNdx ? kWideThreads : kSweepThreads;

template <class S, int NDX, int NU, int G>
__global__ void __launch_bounds__(kFddpThreads<NDX>) riccati_boxfddp_kernel(const BoxSweep<S> a) {
  if constexpr (NDX > kWideNdx) fddp_sweep_wide<S, NDX, NU, true>(a);
  else box_sweep<S, NDX, NU, G, true, true>(a);
}

template <class S, int NDX, int NU, int G>
__global__ void __launch_bounds__(kFddpThreads<NDX>) riccati_fddp_kernel(const BoxSweep<S> a) {
  if constexpr (NDX > kWideNdx) fddp_sweep_wide<S, NDX, NU, false>(a);
  else box_sweep<S, NDX, NU, G, true, false>(a);
}

template <class S>
using SweepKernel = void (*)(const BoxSweep<S>);

// K4 (QP false) or K5 (QP) in the wide layout: its kernel
template <class S, int NDX, int NU, bool QP>
static SweepKernel<S> wide_kernel() {
  if constexpr (QP) return riccati_boxfddp_kernel<S, NDX, NU, 32>;
  else return riccati_fddp_kernel<S, NDX, NU, 32>;
}

// the dynamic shared memory the wide kernel may take, set once (a static
// function, so that each loaded build of this source sets its own
// kernel's), and its launch
template <class S, int NDX, int NU, bool QP>
static cudaError_t wide_allow() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(wide_kernel<S, NDX, NU, QP>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WideSweep<S, NDX, NU, QP>::BYTES);
  return attr;
}

template <class S, int NDX, int NU, bool QP>
static int launch_wide(const BoxSweep<S>& a, cudaStream_t stream) {
  using L = WideSweep<S, NDX, NU, QP>;
  static_assert(L::BYTES <= kMaxSmem, "two stages and the scratch fit in a block");
  const cudaError_t attr = wide_allow<S, NDX, NU, QP>();
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (a.B + L::SPB - 1) / L::SPB;
  if constexpr (QP)
    riccati_boxfddp_kernel<S, NDX, NU, L::G><<<grid, L::THREADS, L::BYTES, stream>>>(a);
  else
    riccati_fddp_kernel<S, NDX, NU, L::G><<<grid, L::THREADS, L::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// the general layout's launch
template <class S, int NDX, int NU, bool GAPS, bool QP>
static int launch_group(const BoxSweep<S>& a, cudaStream_t stream) {
  constexpr int G = kSweepGroup<NDX>;
  using L = Sweep<S, NDX, NU, G, GAPS, QP>;
  static_assert(L::FITS, "the stages, scratch and box rows fit in a block's shared memory");
  const int grid = (a.B + L::SPB - 1) / L::SPB;
  // the box rows' slots only where the tables are given
  const size_t smem = L::BYTES + (a.lbt ? L::BOX_BYTES : 0);
  const int smem_max = (int)(L::BYTES + L::BOX_BYTES);
  if constexpr (!QP) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        riccati_fddp_kernel<S, NDX, NU, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (attr != cudaSuccess) return (int)attr;
    riccati_fddp_kernel<S, NDX, NU, G><<<grid, kSweepThreads, smem, stream>>>(a);
  } else if constexpr (GAPS) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        riccati_boxfddp_kernel<S, NDX, NU, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (attr != cudaSuccess) return (int)attr;
    riccati_boxfddp_kernel<S, NDX, NU, G><<<grid, kSweepThreads, smem, stream>>>(a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        riccati_box_kernel<S, NDX, NU, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (attr != cudaSuccess) return (int)attr;
    riccati_box_kernel<S, NDX, NU, G><<<grid, kSweepThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <class S, int NDX, int NU, bool GAPS, bool QP>
static int launch_shape(const BoxSweep<S>& a, cudaStream_t stream) {
  if constexpr (NDX > kWideNdx) {
    static_assert(GAPS, "the wide layout: K4 and K5, the FDDP family");
    return launch_wide<S, NDX, NU, QP>(a, stream);
  } else {
    return launch_group<S, NDX, NU, GAPS, QP>(a, stream);
  }
}

// 16-byte copies where the batch stride and every staged input allow them
template <class S>
static void set_vec(BoxSweep<S>& a) {
  const void* in[] = {a.Fx, a.Fu, a.Lx, a.Lu, a.Lxx, a.Lxu, a.Luu, a.us, a.kprev, a.fs};
  a.vec = a.B % (16 / (int)sizeof(S)) == 0;
  for (const void* p : in) a.vec = a.vec && aligned16(p);
}

// gaps = 0: K2 (fs, w, dgg, dqg unused) at (8, 4); gaps = 1: K5 at (8, 2),
// (8, 4) and the 3- and 7-DoF SEA arms' (12, 3) and (28, 7). kprev may be
// null (cold QPs from 0). The box tables (lbt, ubt) at ndx 8 only; K2
// above ndx 8 (BoxDDP, which the JAX package's n-DoF lane route cannot
// take) and the tables above it are not built: kNoInstance
template <class S>
static int launch_riccati_box(int ndx, int nu, int gaps, BoxSweep<S> a, void* stream) {
  if (ndx != 8 && (a.lbt || !gaps)) return kNoInstance;
  set_vec(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndx == 8 && nu == 4) {
    if (!gaps) return launch_shape<S, 8, 4, false, true>(a, st);
    return launch_shape<S, 8, 4, true, true>(a, st);
  }
  if (!gaps) return kNoInstance;
  if (ndx == 8 && nu == 2) return launch_shape<S, 8, 2, true, true>(a, st);
  if (ndx == 12 && nu == 3) return launch_shape<S, 12, 3, true, true>(a, st);
  if (ndx == 28 && nu == 7) return launch_shape<S, 28, 7, true, true>(a, st);
  return kNoInstance;
}

// K4 at (ndx, nu) = (8, 2) and (8, 4) (the 2-DoF SEA and VSA arms), (12, 3)
// and (28, 7) (the 3- and 7-DoF SEA arms); us, kprev, lb, ub null
template <class S>
static int launch_riccati_fddp(int ndx, int nu, BoxSweep<S> a, void* stream) {
  set_vec(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndx == 8 && nu == 2) return launch_shape<S, 8, 2, true, false>(a, st);
  if (ndx == 8 && nu == 4) return launch_shape<S, 8, 4, true, false>(a, st);
  if (ndx == 12 && nu == 3) return launch_shape<S, 12, 3, true, false>(a, st);
  if (ndx == 28 && nu == 7) return launch_shape<S, 28, 7, true, false>(a, st);
  return kNoInstance;
}

template <class S, int NDX, int NU, bool GAPS, bool QP>
constexpr int sweep_bytes_of() {
  if constexpr (NDX > kWideNdx) return (int)WideSweep<S, NDX, NU, QP>::BYTES;
  else return (int)Sweep<S, NDX, NU, kSweepGroup<NDX>, GAPS, QP>::BYTES;
}

// K4 (QP false) or K5 (QP) at (28, 7) at a batch of B: its grid, threads a
// block, dynamic shared memory and blocks resident an SM, into out[0 .. 4)
template <class S, bool QP>
static int fddp_wide_launch(int B, int* out) {
  using L = WideSweep<S, 28, 7, QP>;
  const cudaError_t attr = wide_allow<S, 28, 7, QP>();
  if (attr != cudaSuccess) return (int)attr;
  out[0] = (B + L::SPB - 1) / L::SPB;
  out[1] = L::THREADS;
  out[2] = (int)L::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], wide_kernel<S, 28, 7, QP>(), L::THREADS, L::BYTES);
}

template <class S>
static int sweep_bytes(int ndx, int nu, int gaps, int qp) {
  if (!qp) {
    if (ndx == 8 && nu == 2) return sweep_bytes_of<S, 8, 2, true, false>();
    if (ndx == 8 && nu == 4) return sweep_bytes_of<S, 8, 4, true, false>();
    if (ndx == 12 && nu == 3) return sweep_bytes_of<S, 12, 3, true, false>();
    if (ndx == 28 && nu == 7) return sweep_bytes_of<S, 28, 7, true, false>();
    return kNoInstance;
  }
  if (!gaps) return ndx == 8 && nu == 4 ? sweep_bytes_of<S, 8, 4, false, true>() : kNoInstance;
  if (ndx == 8 && nu == 2) return sweep_bytes_of<S, 8, 2, true, true>();
  if (ndx == 8 && nu == 4) return sweep_bytes_of<S, 8, 4, true, true>();
  if (ndx == 12 && nu == 3) return sweep_bytes_of<S, 12, 3, true, true>();
  return ndx == 28 && nu == 7 ? sweep_bytes_of<S, 28, 7, true, true>() : kNoInstance;
}

}  // namespace aslr

// the dynamic shared memory of one block of the (ndx, nu, gaps)
// instantiation of the box kernel (K2, K5) for 4- or 8-byte scalars, in
// bytes (without the box tables' slots); -1 if there is none
extern "C" int aslr_riccati_box_smem(int ndx, int nu, int gaps, int itemsize) {
  if (itemsize == 4) return aslr::sweep_bytes<float>(ndx, nu, gaps, 1);
  return itemsize == 8 ? aslr::sweep_bytes<double>(ndx, nu, gaps, 1) : aslr::kNoInstance;
}

// the same for K4 at (ndx, nu)
extern "C" int aslr_riccati_fddp_smem(int ndx, int nu, int itemsize) {
  if (itemsize == 4) return aslr::sweep_bytes<float>(ndx, nu, 1, 0);
  return itemsize == 8 ? aslr::sweep_bytes<double>(ndx, nu, 1, 0) : aslr::kNoInstance;
}

// K4 at (28, 7), 4- or 8-byte scalars, at a batch of B: grid, threads,
// dynamic shared memory and blocks resident an SM into out[0 .. 4); the
// CUDA error, or -1 for another itemsize
extern "C" int aslr_riccati_fddp_n7_launch(int itemsize, int B, int* out) {
  if (itemsize == 4) return aslr::fddp_wide_launch<float, false>(B, out);
  return itemsize == 8 ? aslr::fddp_wide_launch<double, false>(B, out) : aslr::kNoInstance;
}

// the same for K5 at (28, 7)
extern "C" int aslr_riccati_boxfddp_n7_launch(int itemsize, int B, int* out) {
  if (itemsize == 4) return aslr::fddp_wide_launch<float, true>(B, out);
  return itemsize == 8 ? aslr::fddp_wide_launch<double, true>(B, out) : aslr::kNoInstance;
}

#define ASLR_RICCATI_BOX_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(int ndx, int nu, int gaps, const S* Fx, const S* Fu, const S* Lx,       \
                      const S* Lu, const S* Lxx, const S* Lxu, const S* Luu, const S* tLx,    \
                      const S* tLxx, const S* fs, const S* us, const S* kprev, const S* lb,   \
                      const S* ub, const S* lbt, const S* ubt, const S* reg, int T, int B,    \
                      int qp_iters, S* k, S* K, S* w, S* dg, S* dq, S* stop, S* dgg, S* dqg,  \
                      bool* ok, bool* retryable, void* stream) {                              \
    aslr::BoxSweep<S> a{Fx, Fu, Lx, Lu, Lxx,   Lxu,  Luu, tLx, tLxx, fs, us, kprev, lb,      \
                        ub, reg, lbt, ubt, T, B, qp_iters, false, k, K, w, dg, dq, stop, dgg, \
                        dqg, ok, retryable};                                                  \
    return aslr::launch_riccati_box<S>(ndx, nu, gaps, a, stream);                             \
  }

#define ASLR_RICCATI_FDDP_ENTRY(NAME, S)                                                      \
  extern "C" int NAME(int ndx, int nu, const S* Fx, const S* Fu, const S* Lx, const S* Lu,    \
                      const S* Lxx, const S* Lxu, const S* Luu, const S* tLx, const S* tLxx,  \
                      const S* fs, const S* reg, int T, int B, S* k, S* K, S* w, S* dg,       \
                      S* dq, S* stop, S* dgg, S* dqg, bool* ok, bool* retryable,              \
                      void* stream) {                                                         \
    aslr::BoxSweep<S> a{Fx,  Fu,  Lx, Lu, Lxx,  Lxu, Luu, tLx,   tLxx, fs, nullptr, nullptr,  \
                        nullptr, nullptr, reg, nullptr, nullptr, T, B, 0, false, k, K, w, dg, \
                        dq, stop, dgg, dqg, ok, retryable};                                   \
    return aslr::launch_riccati_fddp<S>(ndx, nu, a, stream);                                  \
  }

ASLR_RICCATI_BOX_ENTRY(aslr_riccati_box_f32, float)
ASLR_RICCATI_BOX_ENTRY(aslr_riccati_box_f64, double)
ASLR_RICCATI_FDDP_ENTRY(aslr_riccati_fddp_f32, float)
ASLR_RICCATI_FDDP_ENTRY(aslr_riccati_fddp_f64, double)
