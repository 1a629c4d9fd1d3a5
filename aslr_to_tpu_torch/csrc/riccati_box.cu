// K2 and K5: the box backward Riccati sweeps, one template. GAPS = false is
// K2 (Box-DDP), GAPS = true is K5 (BoxFDDP: K2 plus the FDDP deflection).
//
// Replaces the Pallas kernels aslr_to_tpu/pallas/riccati.py::
// _riccati_box_kernel (launched by prepare_riccati_box_backward_lanes, with
// its helpers _boxqp_lanes, _masked_chol_solve, _chol4, _chol4_solve) and
// _riccati_fddp_kernel with boxed=True (launched by
// prepare_riccati_boxfddp_backward_lanes). Per scenario, over the knots
// T-1 .. 0:
//   Q terms from (Vx, Vxx), Quu + reg I;
//   a masked projected-Newton BoxQP on the box (lb - u, ub - u), started
//   from -kprev (warm) or 0 (cold): qp_iters iterations, each a masked
//   Cholesky Newton step and a 5-step Armijo search;
//   the free-subspace gains K from a masked Cholesky;
//   the value update with symmetrization and reg; for K5 the deflection
//   w_t = Vxx_t fs_t and Vx += w_t (after the terminal node's own w_T);
//   the sums dg, dq, stop (K5: and dg_gap = -sum Vx.fs, dq_gap = sum fs.w)
//   and the flags ok and retryable (a failure whose Quu was still finite).
//
// What bounds it: the instructions each warp issues. The bytes (228-236
// values a knot and scenario) take 0.13 ms at T=100, B=4096 on an H100; the
// knot loop is a dependent chain per scenario, and the BoxQP inside it a
// chain of IEEE divisions and square roots (up to 54 a knot). The earlier
// design (one thread a scenario) ran 4096 threads, read every derivative
// from global memory inside the products, solved the eight gain columns one
// after another and spilled in f64. This one:
//   - spreads a scenario over a group of G >= NDX lanes of one warp (G = 8:
//     four scenarios a warp, 16 a block of 128 threads, 256 blocks at
//     B = 4096). Lane r owns row r of Fx^T Vxx, Qx, Qxu and the new Vxx,
//     and column r of the gains K, so the NDX column solves run side by
//     side. Vx, Vxx, the exchanged Q blocks and K sit in the block's shared
//     memory; the group meets at __syncwarp on its own mask and votes with
//     __all_sync / __ballot_sync on that mask, never the whole warp's.
//     Wider groups (16, 32 lanes) run slower: the work every lane of a
//     group repeats (the QP) then serves fewer scenarios a warp instruction;
//   - stages each knot's inputs in shared memory with cp.async, coalesced
//     along the batch axis ([rows, scenarios] tiles, 16-byte copies where
//     the batch stride and the pointers allow, else one element a copy),
//     double-buffered: knot t-1's copy is in flight while knot t computes,
//     so no global load sits on the dependent chain;
//   - runs the BoxQP's factor and solves redundantly on every lane of the
//     group (a SIMT instruction costs the same on one lane or eight), its
//     five Armijo trials on five lanes (accepted in order by a ballot, the
//     winner's point shuffled from its lane), and keeps the masked factor
//     while the free set does not change (boxqp.cuh);
//   - skips the division of a zero dividend (boxqp.cuh::div0): the clamped
//     controls zero whole rows of the masked systems, and IEEE division
//     sends a zero dividend down its slow path.
// aslr_to_tpu_torch/box_variants.py times each of these choices against
// its alternative on the card.
// The products are 8x8x8 per scenario, each scenario with its own
// operands, so no tensor cores: TF32 would cut f32 precision, and f64 DMMA
// would change the summation order. Every dot product runs in one thread
// in the order of its plain version (aslr_to_tpu_torch/kernels/riccati.py),
// and the build has -fmad=false, so the kernel equals its plain version to
// the bit; FMA contraction would trade that for a tolerance.
//
// The ragged last block keeps its out-of-range groups in every barrier:
// they compute on whatever the stage holds and skip their loads and stores.
#include <cuda_pipeline.h>

#include "boxqp.cuh"

namespace aslr {

template <class S>
struct BoxSweep {
  const S *Fx, *Fu, *Lx, *Lu, *Lxx, *Lxu, *Luu, *tLx, *tLxx, *fs, *us, *kprev, *lb, *ub, *reg;
  int T, B, qp_iters;
  bool vec;  // 16-byte copies: the batch stride and every input pointer allow them
  S *k, *K, *w, *dg, *dq, *stop, *dgg, *dqg;
  bool *ok, *retryable;
};

constexpr int kSweepThreads = 128;

// The block's shared memory: two stages of knot inputs, each a [rows, P]
// tile (P = scenarios a block plus 16 bytes, which spreads a warp's four
// scenarios over the banks), then one scratch region a scenario.
template <class S, int NDX, int NU, int G, bool GAPS>
struct Sweep {
  static constexpr int SPB = kSweepThreads / G;
  static constexpr int VEC = 16 / (int)sizeof(S);
  static constexpr int P = SPB + VEC;
  static_assert(G >= NDX && G >= 5, "a lane a row, and five Armijo trials");
  static_assert(SPB % VEC == 0, "16-byte copies tile the scenarios of a block");
  // stage rows, per knot and scenario
  static constexpr int rFx = 0, rFu = rFx + NDX * NDX, rLx = rFu + NDX * NU, rLu = rLx + NDX,
                       rLxx = rLu + NU, rLxu = rLxx + NDX * NDX, rLuu = rLxu + NDX * NU,
                       rUs = rLuu + NU * NU, rKp = rUs + NU, rFs = rKp + NU,
                       ROWS = rFs + (GAPS ? NDX : 0), STAGE = ROWS * P;
  // scratch, per scenario: Vxx (column r written by lane r), Vx, w, the
  // exchanged FuTVxx (then the unsymmetrized V), Qu, Quu and K
  static constexpr int oVxx = 0, oVx = NDX * NDX, oW = oVx + NDX, oX = oW + NDX,
                       oQu = oX + NDX * NDX, oQuu = oQu + NU, oK = oQuu + NU * NU,
                       USED = oK + NU * NDX;
  static constexpr int SC = (USED + 31) / 32 * 32 + 8;  // four scenarios of a warp, 8 banks apart
  static constexpr size_t BYTES = (size_t)(2 * STAGE + SPB * SC) * sizeof(S);
};

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
  stage_rows<L, V>(dst + L::rUs * L::P, a.us, L::rKp - L::rUs, t, TB, b0, tid);
  if (a.kprev) stage_rows<L, V>(dst + L::rKp * L::P, a.kprev, L::rFs - L::rKp, t, TB, b0, tid);
  if constexpr (L::ROWS > L::rFs)
    stage_rows<L, V>(dst + L::rFs * L::P, a.fs, L::ROWS - L::rFs, t, TB, b0, tid);
}

template <class L, class S>
__device__ inline void stage(const BoxSweep<S>& a, S* dst, long long t, int b0, int tid) {
  if (a.vec) stage_knot<L, L::VEC>(a, dst, t, b0, tid);
  else stage_knot<L, 1>(a, dst, t, b0, tid);
  __pipeline_commit();
}

template <class S, int NDX, int NU, int G, bool GAPS>
__device__ inline void box_sweep(const BoxSweep<S>& a) {
  using L = Sweep<S, NDX, NU, G, GAPS>;
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
  S* const my = stages + 2 * L::STAGE + s * L::SC;
  S *const vxx = my + L::oVxx, *const vx = my + L::oVx, *const ws = my + L::oW;
  S *const xs = my + L::oX, *const qus = my + L::oQu, *const quus = my + L::oQuu;
  S* const ks = my + L::oK;

  if (a.T > 0) stage<L>(a, stages + ((a.T - 1) & 1) * L::STAGE, a.T - 1, b0, tid);

  const S reg = a.reg[bc];
  S lo[NU], hi[NU];
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
    if (t > 0) stage<L>(a, stages + ((t - 1) & 1) * L::STAGE, t - 1, b0, tid);
    const S* const st = stages + (t & 1) * L::STAGE + s;
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

    // box QP on du in (lb - u, ub - u), warm-started from -kprev
    S low[NU], up[NU], du[NU], free[NU];
    for (int j = 0; j < NU; ++j) {
      const S u_t = in(L::rUs + j);
      low[j] = lo[j] - u_t;
      up[j] = hi[j] - u_t;
      du[j] = a.kprev ? -in(L::rKp + j) : S(0);
    }
    S Lf[NU][NU];
    boxqp_group<S, NU>(grp, Quu, Qu, low, up, a.qp_iters, du, free, Lf);
    S k[NU];
    for (int j = 0; j < NU; ++j) k[j] = -du[j];

    // column r of the free-subspace gains: masked solve with row r of Qxu
    S kc[NU];
    {
      S rhs[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = qxu[i] * free[i];
      chol_solve<S, NU, true>(Lf, rhs, kc);
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

// two entry kernels over one body, so that a profile tells K2 from K5
template <class S, int NDX, int NU, int G>
__global__ void __launch_bounds__(kSweepThreads) riccati_box_kernel(const BoxSweep<S> a) {
  box_sweep<S, NDX, NU, G, false>(a);
}

template <class S, int NDX, int NU, int G>
__global__ void __launch_bounds__(kSweepThreads) riccati_boxfddp_kernel(const BoxSweep<S> a) {
  box_sweep<S, NDX, NU, G, true>(a);
}

template <class S, int NDX, int NU, bool GAPS>
static int launch_shape(const BoxSweep<S>& a, cudaStream_t stream) {
  constexpr int G = NDX;
  using L = Sweep<S, NDX, NU, G, GAPS>;
  const int grid = (a.B + L::SPB - 1) / L::SPB;
  if constexpr (GAPS) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        riccati_boxfddp_kernel<S, NDX, NU, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    riccati_boxfddp_kernel<S, NDX, NU, G><<<grid, kSweepThreads, L::BYTES, stream>>>(a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        riccati_box_kernel<S, NDX, NU, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    riccati_box_kernel<S, NDX, NU, G><<<grid, kSweepThreads, L::BYTES, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// gaps = 0: K2 (fs, w, dgg, dqg unused); gaps = 1: K5. kprev may be null
// (cold QPs from 0).
template <class S>
static int launch_riccati_box(int ndx, int nu, int gaps, BoxSweep<S> a, void* stream) {
  if (ndx != 8 || (nu != 4 && !(gaps && nu == 2))) return -1;
  const void* in[] = {a.Fx, a.Fu, a.Lx, a.Lu, a.Lxx, a.Lxu, a.Luu, a.us, a.kprev, a.fs};
  a.vec = a.B % (16 / (int)sizeof(S)) == 0;
  for (const void* p : in) a.vec = a.vec && aligned16(p);
  cudaStream_t st = (cudaStream_t)stream;
  if (!gaps) return launch_shape<S, 8, 4, false>(a, st);
  return nu == 2 ? launch_shape<S, 8, 2, true>(a, st) : launch_shape<S, 8, 4, true>(a, st);
}

template <class S>
static int sweep_bytes(int nu, int gaps) {
  if (!gaps) return nu == 4 ? (int)Sweep<S, 8, 4, 8, false>::BYTES : -1;
  if (nu == 2) return (int)Sweep<S, 8, 2, 8, true>::BYTES;
  return nu == 4 ? (int)Sweep<S, 8, 4, 8, true>::BYTES : -1;
}

}  // namespace aslr

// the dynamic shared memory of one block of the (ndx 8, nu, gaps)
// instantiation for 4- or 8-byte scalars, in bytes; -1 if there is none
extern "C" int aslr_riccati_box_smem(int nu, int gaps, int itemsize) {
  if (itemsize == 4) return aslr::sweep_bytes<float>(nu, gaps);
  return itemsize == 8 ? aslr::sweep_bytes<double>(nu, gaps) : -1;
}

#define ASLR_RICCATI_BOX_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(int ndx, int nu, int gaps, const S* Fx, const S* Fu, const S* Lx,       \
                      const S* Lu, const S* Lxx, const S* Lxu, const S* Luu, const S* tLx,    \
                      const S* tLxx, const S* fs, const S* us, const S* kprev, const S* lb,   \
                      const S* ub, const S* reg, int T, int B, int qp_iters, S* k, S* K,      \
                      S* w, S* dg, S* dq, S* stop, S* dgg, S* dqg, bool* ok, bool* retryable, \
                      void* stream) {                                                         \
    aslr::BoxSweep<S> a{Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev,              \
                        lb, ub, reg, T, B, qp_iters, false, k, K, w, dg, dq, stop, dgg, dqg, \
                        ok, retryable};                                                       \
    return aslr::launch_riccati_box<S>(ndx, nu, gaps, a, stream);                             \
  }

ASLR_RICCATI_BOX_ENTRY(aslr_riccati_box_f32, float)
ASLR_RICCATI_BOX_ENTRY(aslr_riccati_box_f64, double)
