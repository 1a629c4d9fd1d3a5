// K1: knot linearization of the soft arm, VSA or SEA.
//
// Replaces the Pallas kernel aslr_to_tpu/pallas/vsa_kernels.py::
// _linearize_kernel (launched twice by build_linearize(lane_io=True): the
// running knots and the terminal knot). Per knot and scenario it computes
// the forward dynamics, the acceleration Jacobians from 2*NL forward-mode
// RNEA seeds (dual numbers instead of jax.jvp) plus the spring columns and,
// for the VSA, the stiffness-control columns (the SEA's constant spring
// enters Fx through K instead, and its Fu has the NL motor-torque columns
// only: the is_vsa=False branch of the Pallas kernel, selected here by the
// template parameter SEA), the Euler chain rule (Fx, Fu, xnext), the goal
// residual log6 and its Jacobian from NL dual seeds, the Gauss-Newton cost
// derivatives, and a finiteness flag over the derivative tensors. One
// launch covers every knot, the terminal knot included as knot T. The goal's
// target is the parameter block's (running or terminal) or, for a per-knot
// target (vsa_kernels.py::_tgt_at), row t of a [T, 12] table at running
// knot t: a null table pointer picks the former by a uniform branch, so one
// instance serves both.
//
// What bounds it on the H100: each running VSA knot writes 228 values
// (Fx 64, Fu 32, Lx 8, Lu 4, Lxx 64, Lxu 32, Luu 16, xnext 8) plus cost and
// flag, so at T=100, B=4096 the bytes take about 0.12 ms in f32 at 3.35
// TB/s (the SEA knot writes 194 values: nu = 2). The arithmetic is a few
// thousand operations a knot, most of them dual-number RNEA and goal
// evaluations. The earlier design, one thread a (knot, scenario), ran NL
// goal seeds, NL + 1 RNEA sweeps of the mass matrix and 2 NL dual RNEA seeds
// in series, and made dual numbers of the robot's constants. This design:
//   - spreads a (knot, scenario) over a group of G lanes of one warp (G = 2
//     = NL: sixteen a warp, 64 a block of 128 threads), each lane running
//     the same instructions on lane-chosen data (as rollout.cu's groups
//     do): lane j takes goal seed j, RNEA seeds j and j + G (the dual sweeps
//     in q_j and in v_j), and sweeps j and j + G of mass_nle
//     (lanes.cuh::mass_nle_sweep: the nle, then M's columns; the one sweep
//     past NL repeats the last). The group exchanges the goal Jacobian, M,
//     nle and the RNEA partials by shuffles on its own mask
//     (common.cuh::Group), and every lane then holds the values every row
//     needs. The code is written for any G: a lane takes several tasks
//     where the group has fewer lanes than tasks, and lanes past the tasks
//     repeat one;
//   - divides the outputs among the lanes by rows: lane r computes entries
//     r and r + G of the acceleration Jacobian's columns and writes rows r,
//     r + G, r + 2 NL and r + 2 NL + G of Fx, Fu, Lx, Lxx and Lxu, and rows
//     r and r + G of Lu and Luu;
//   - keeps the robot's constants scalars (lanes.cuh::Mix), so a constant
//     times a dual costs the plain version's two multiplications;
//   - runs every group through the same shuffles (the terminal knot too,
//     whose dynamics it computes and does not store), so a warp that holds
//     running and terminal knots stays converged, and the ragged last block
//     keeps its out-of-range groups in every shuffle: they compute on the
//     last knot and skip their stores.
// aslr_to_tpu_torch/linearize_variants.py times each of these choices
// against its alternative on the card: one lane runs as fast as two; four
// and eight lanes run slower (at four, the stores alone take about half
// the kernel's time, and staging them through shared memory, kStageOut,
// wins back only part of it); unrolling every loop, which takes the dual
// RNEA's arrays out of the stack frame, costs registers and time.
//
// Above NL = 2 the mass solves are an unrolled Cholesky (lanes.cuh::choln,
// choln_solve, as the Pallas kernel's ops/lanes.py::choln and solven): the
// accelerations solve M a = rhs, and each entry of the link rows of the
// acceleration Jacobian solves its column (msolve_r), as the plain version
// does. The group stays 2 lanes at every NL (a lane then takes several goal
// seeds, sweeps, RNEA seeds and rows: ceil(NL / 2), ceil((NL + 1) / 2) and
// NL of each); only the SEA arm is instantiated above NL = 2.
//
// Every value is computed by one lane with the operations of the plain
// version (aslr_to_tpu_torch/kernels/vsa_kernels.py::linearize_plain), in
// its order; the sweeps and seeds differ only in inputs chosen by value,
// and the build has -fmad=false, so the kernel equals its plain version to
// the bit. It writes the constant tensors (Lxu = 0, diagonal Luu) too, to
// keep its interface equal to the Pallas kernel's.
//
// This header holds the kernel; linearize.cu instantiates it at nl = 2,
// linearize_n3.cu and linearize_n7.cu at 3 and 7, each a translation unit
// of its own so that nvcc compiles them side by side.
#pragma once

#include "lanes.cuh"

namespace aslr {

constexpr int kLinThreads = 128;
constexpr int kLinGroup = 2;        // lanes a (knot, scenario)
constexpr bool kStageOut = false;   // outputs through the block's shared memory

template <class S>
struct Lin {
  const S *xs, *us, *wterm;
  const S* tgt;  // [T, 12] the running knots' targets, row t knot t's; null: P's one
  int T, B;
  S *Fx, *Fu, *Lx, *Lu, *Lxx, *Lxu, *Luu, *xnext, *cost;
  bool* ok;
  S *tLx, *tLxx, *tcost;
  bool* tok;
};

// One (knot, scenario)'s running outputs in the order of the block's output
// tile [E, P] (kStageOut: P = groups a block + 1, so that neither the
// lanes of a group nor the write-out meet in a bank); the terminal knot's
// tLx and tLxx take the rows of Lx and Lxx
template <int NDX, int NU, int G>
struct LinOut {
  static constexpr int oFx = 0, oFu = NDX * NDX, oLx = oFu + NDX * NU, oLu = oLx + NDX,
                       oLxx = oLu + NU, oLxu = oLxx + NDX * NDX, oLuu = oLxu + NDX * NU,
                       oXn = oLuu + NU * NU, E = oXn + NDX;
  static constexpr int SPB = kLinThreads / G, P = SPB + 1;
  static constexpr size_t BYTES(size_t itemsize) { return kStageOut ? E * P * itemsize : 0; }
};

// a[idx] for a run-time idx < N, by selects: an array indexed at run time
// would go to local memory
template <int N, class T>
__device__ inline T pick(const T* a, int idx) {
  T v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = i == idx ? a[i] : v;
  return v;
}

// sum_i c_i v_i in order from i = 0 (the plain version's msolve at NL = 2
// and its binv_apply)
template <int N, class S>
__device__ inline S dotn(const S* c, const S* v) {
  S acc = c[0] * v[0];
  for (int i = 1; i < N; ++i) acc = acc + c[i] * v[i];
  return acc;
}

template <class S, int NL, bool SEA, int G, int TAB>
__device__ inline void linearize_group(const VSAParams<NL>& P, const Lin<S>& a) {
  constexpr int NDX = Arm<NL, SEA>::NDX, NU = Arm<NL, SEA>::NU, NV = 2 * NL;
  constexpr int MG = (NL + G - 1) / G;      // goal seeds a lane
  constexpr int MS = (NL + 1 + G - 1) / G;  // mass_nle sweeps a lane
  constexpr int MR = (NV + G - 1) / G;      // RNEA seeds a lane, and rows a lane
  typedef Dual<S> D;
  using O = LinOut<NDX, NU, G>;
  extern __shared__ __align__(16) unsigned char lin_smem[];
  [[maybe_unused]] S* const tile = reinterpret_cast<S*>(lin_smem);
  const Group<G> grp;
  const int lane = grp.lane;
  const long long TB = a.B, N = (long long)(a.T + 1) * TB;
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = n < N;
  const long long nc = live ? n : N - 1;  // where an out-of-range group reads
  const long long t = nc / TB, b = nc % TB;
  const bool terminal = t == a.T;
  // element e of this group's outputs to dst (kStageOut: to its tile slot)
  auto store = [&](bool cond, int e, S* dst, S v) {
    if constexpr (kStageOut) {
      if (cond) tile[e * O::P + threadIdx.x / G] = v;
    } else {
      if (cond) *dst = v;
    }
  };

  S x[NDX], u[NU];
  for (int i = 0; i < NDX; ++i) x[i] = a.xs[(t * NDX + i) * TB + b];
  for (int j = 0; j < NU; ++j) u[j] = terminal ? S(0) : a.us[(t * NU + j) * TB + b];
  const S* q_l = x;
  const S* q_m = x + NL;
  const S* v_l = x + 2 * NL;

  // goal residual and its Jacobian wrt q_l: seed g on lane g mod G (the
  // values r6 and the cost are the same on every seed). The target: the
  // table's row of a running knot (TAB: always, or where the table is
  // given), else the parameter block's running or terminal one
  const bool tab = TAB == kTables || (TAB == kEither && a.tgt != nullptr);
  const S* const row = tab && !terminal ? a.tgt + t * 12 : nullptr;
  S Jo[MG][6], r6[6], c_goal = S(0);
  for (int m = 0; m < MG; ++m) {
    const int g = (lane + m * G) % NL;
    D qd[NL], rd[6];
    for (int i = 0; i < NL; ++i) qd[i] = D(q_l[i], S(i == g ? 1 : 0));
    const D cd = goal_cost<D, NL>(P, qd, terminal, row, rd);
    for (int k = 0; k < 6; ++k) Jo[m][k] = rd[k].d;
    if (m == 0) {
      c_goal = cd.v;
      for (int k = 0; k < 6; ++k) r6[k] = rd[k].v;
    }
  }
  S J[NL][6];
  for (int j = 0; j < NL; ++j)
    for (int k = 0; k < 6; ++k) J[j][k] = grp.from(j % G, Jo[j / G][k]);
  const S w_goal = terminal ? a.wterm[b] : S(P.w_goal);

  S c = w_goal * c_goal;
  if (!terminal) {
    for (int i = 0; i < NDX; ++i)
      if (P.xw[i] != 0.0) c = c + S(0.5 * P.xw[i]) * x[i] * x[i];
    for (int i = 0; i < NU; ++i)
      if (P.uw[i] != 0.0) c = c + S(0.5 * P.uw[i]) * u[i] * u[i];
    if constexpr (!SEA) {
      if (P.stiff_w != 0.0)
        for (int i = 0; i < NL; ++i) c = c + S(P.stiff_w) * (u[NL + i] - S(P.stiff_ref[i]));
    }
  }

  // this lane's rows r = lane + m G (mod NV) and r + NV of the outputs
  // (the running ones, or tLx/tLxx at the terminal knot)
  S* const Lx_o = terminal ? a.tLx : a.Lx + t * NDX * TB;
  S* const Lxx_o = terminal ? a.tLxx : a.Lxx + t * NDX * NDX * TB;
  bool fin = true;
  for (int m = 0; m < MR; ++m) {
    const int r = (lane + m * G) % NV, r2 = r + NV;
    const bool own = live && lane + m * G < NV, run = own && !terminal;
    const double xw1 = pick<NDX>(P.xw, r), xw2 = pick<NDX>(P.xw, r2);
    const bool reg1 = !terminal && xw1 != 0.0, reg2 = !terminal && xw2 != 0.0;
    S Jr[6];
    for (int k = 0; k < 6; ++k) {
      Jr[k] = J[0][k];
      for (int j = 1; j < NL; ++j) Jr[k] = j == r ? J[j][k] : Jr[k];
    }
    {  // Lx: the goal term on the rows of q_l, the state reg
      S g = S(0);
      for (int k = 0; k < 6; ++k) g = g + w_goal * Jr[k] * r6[k];
      S v1 = r < NL ? g : S(0), v2 = S(0);
      if (reg1) v1 = v1 + S(xw1) * pick<NDX>(x, r);
      if (reg2) v2 = v2 + S(xw2) * pick<NDX>(x, r2);
      fin = fin && finite(v1) && finite(v2);
      store(own, O::oLx + r, Lx_o + r * TB + b, v1);
      store(own, O::oLx + r2, Lx_o + r2 * TB + b, v2);
    }
    for (int j = 0; j < NDX; ++j) {  // Lxx: Gauss-Newton on the q_l block, the reg diagonal
      S v1 = S(0), v2 = S(0);
      if (j < NL) {
        S g = S(0);
        for (int k = 0; k < 6; ++k) g = g + w_goal * Jr[k] * J[j < NL ? j : 0][k];
        v1 = r < NL ? g : S(0);
      }
      if (j == r && reg1) v1 = v1 + S(xw1);
      if (j == r2 && reg2) v2 = v2 + S(xw2);
      fin = fin && finite(v1) && finite(v2);
      store(own, O::oLxx + r * NDX + j, Lxx_o + (r * NDX + j) * TB + b, v1);
      store(own, O::oLxx + r2 * NDX + j, Lxx_o + (r2 * NDX + j) * TB + b, v2);
    }
    if (r < NU) {  // Lu and row r of Luu
      const double uw = pick<2 * NL>(P.uw, r);
      S v = S(0);
      if (uw != 0.0) v = v + S(uw) * pick<NU>(u, r);
      if constexpr (!SEA) {
        if (P.stiff_w != 0.0 && r >= NL) v = v + S(P.stiff_w);
      }
      fin = fin && (terminal || finite(v));
      store(run, O::oLu + r, a.Lu + (t * NU + r) * TB + b, v);
      for (int j = 0; j < NU; ++j) {
        S d = S(0);
        if (j == r && uw != 0.0) d = d + S(uw);
        store(run, O::oLuu + r * NU + j, a.Luu + ((t * NU + r) * NU + j) * TB + b, d);
      }
    }
    for (int j = 0; j < NU; ++j) {
      store(run, O::oLxu + r * NU + j, a.Lxu + ((t * NDX + r) * NU + j) * TB + b, S(0));
      store(run, O::oLxu + r2 * NU + j, a.Lxu + ((t * NDX + r2) * NU + j) * TB + b, S(0));
    }
  }

  // -- dynamics: the sweeps of mass_nle, sweep cs on lane cs mod G ---------
  S sw[MS][NL];
  for (int m = 0; m < MS; ++m) {
    const int cs = lane + m * G < NL ? lane + m * G : NL;
    mass_nle_sweep<S, NL>(P, x, v_l, cs, sw[m]);
  }
  S M[NL][NL], nle[NL];
  for (int i = 0; i < NL; ++i) nle[i] = grp.from(0, sw[0][i]);
  for (int j = 0; j < NL; ++j)
    for (int i = 0; i < NL; ++i) M[i][j] = grp.from((j + 1) % G, sw[(j + 1) / G][i]);
  S tau_c[NL], acc[NV];
  spring_torque<S, NL, SEA>(P, x, u, tau_c);
  accelerations<S, NL>(P, u, tau_c, M, nle, acc);

  // RNEA partials at (q_l, v_l, a_l): seed s on lane s mod G, dtau/dq_s for
  // s < NL, else dtau/dv_{s-NL}
  S dto[MR][NL];
  for (int m = 0; m < MR; ++m) {
    const int s = (lane + m * G) % NV;
    D qd[NL], vd[NL], ad[NL], tau[NL];
    for (int i = 0; i < NL; ++i) {
      qd[i] = D(q_l[i], S(s == i ? 1 : 0));
      vd[i] = D(v_l[i], S(s == NL + i ? 1 : 0));
      ad[i] = D(acc[i]);
    }
    rnea<D, NL>(P, qd, vd, ad, true, tau);
    for (int i = 0; i < NL; ++i) dto[m][i] = tau[i].d;
  }
  S dtau_dq[NL][NL], dtau_dv[NL][NL];
  for (int j = 0; j < NL; ++j)
    for (int i = 0; i < NL; ++i) {
      dtau_dq[j][i] = grp.from(j % G, dto[j / G][i]);
      dtau_dv[j][i] = grp.from((NL + j) % G, dto[(NL + j) / G][i]);
    }

  S Minv[NL][NL] = {}, Lfac[NL][NL];  // M^-1 at NL = 2, else M's Cholesky factor
  if constexpr (NL == 2) {
    S det = M[0][0] * M[1][1] - M[0][1] * M[1][0];
    S idet = S(1) / det;
    Minv[0][0] = M[1][1] * idet;
    Minv[0][1] = -M[0][1] * idet;
    Minv[1][0] = -M[1][0] * idet;
    Minv[1][1] = M[0][0] * idet;
  } else {
    choln<S, NL>(M, Lfac);
  }
  // dK[j][i] = d tau_c_i / d q_l_j: the VSA's k_j on the diagonal, or the
  // SEA's spring column K[:, j]
  S dK[NL][NL];
  for (int j = 0; j < NL; ++j)
    for (int i = 0; i < NL; ++i) {
      if constexpr (SEA)
        dK[j][i] = S(P.K[i][j]);
      else
        dK[j][i] = (i == j) ? u[NL + j] : S(0);
    }

  // -- the rows of the Euler chain rule: entry r of each column of
  // d a / d [q_l, q_m, v_l, v_m, tau (, k)], then rows r and r + NV of Fx
  // and Fu, and of xnext
  const S dt = S(P.dt);
  const S dt2 = S(P.dt * P.dt);
  for (int m = 0; m < MR; ++m) {
    const int r = (lane + m * G) % NV, r2 = r + NV;
    const bool run = live && !terminal && lane + m * G < NV;
    const bool link = r < NL;  // a link acceleration (M^-1 ...), else a motor one (Binv ...)
    const int rl = link ? r : 0, rm = link ? 0 : r - NL;
    S mrow[NL], brow[NL];  // row rl of M^-1 (NL = 2), row rm of Binv
    for (int i = 0; i < NL; ++i) {
      S mi = Minv[0][i], bi = S(P.binv[0][i]);
      for (int k = 1; k < NL; ++k) {
        mi = k == rl ? Minv[k][i] : mi;
        bi = k == rm ? S(P.binv[k][i]) : bi;
      }
      mrow[i] = mi;
      brow[i] = bi;
    }
    // entry rl of M^-1 col
    auto msolve_r = [&](const S* col) {
      if constexpr (NL == 2) {
        return dotn<NL>(mrow, col);
      } else {
        S out[NL];
        choln_solve<S, NL>(Lfac, col, out);
        return pick<NL>(out, rl);
      }
    };
    auto put = [&](int c, S v) {  // entry r of input column c
      if (c < NDX) {
        S f1 = v * dt2;
        if (c == r) f1 = f1 + S(1);
        if (c == r2) f1 = f1 + dt;
        S f2 = v * dt;
        if (c == r2) f2 = f2 + S(1);
        fin = fin && (terminal || (finite(f1) && finite(f2)));
        store(run, O::oFx + r * NDX + c, a.Fx + ((t * NDX + r) * NDX + c) * TB + b, f1);
        store(run, O::oFx + r2 * NDX + c, a.Fx + ((t * NDX + r2) * NDX + c) * TB + b, f2);
      } else {
        const S f1 = v * dt2, f2 = v * dt;
        fin = fin && (terminal || (finite(f1) && finite(f2)));
        const int cu = c - NDX;
        store(run, O::oFu + r * NU + cu, a.Fu + ((t * NDX + r) * NU + cu) * TB + b, f1);
        store(run, O::oFu + r2 * NU + cu, a.Fu + ((t * NDX + r2) * NU + cu) * TB + b, f2);
      }
    };
    for (int j = 0; j < NL; ++j) {
      S tmp[NL], ntv[NL];
      for (int i = 0; i < NL; ++i) {
        tmp[i] = -(dtau_dq[j][i]) - dK[j][i];
        ntv[i] = -dtau_dv[j][i];
      }
      const S mot = dotn<NL>(brow, dK[j]);  // entry rm of Binv dK
      put(j, link ? msolve_r(tmp) : mot);             // q_l_j
      put(NL + j, link ? msolve_r(dK[j]) : -mot);     // q_m_j: the spring's sign flips
      put(2 * NL + j, link ? msolve_r(ntv) : S(0));   // v_l_j
      put(3 * NL + j, S(0));                          // v_m_j
      put(4 * NL + j, link ? S(0) : brow[j]);         // tau_j
      if constexpr (!SEA) {                           // k_j
        const S d = q_l[j] - q_m[j];
        S lk;
        if constexpr (NL == 2) {
          lk = mrow[j] * -d;
        } else {
          S e[NL];
          for (int i = 0; i < NL; ++i) e[i] = (i == j) ? -d : S(0);
          lk = msolve_r(e);
        }
        put(5 * NL + j, link ? lk : brow[j] * d);
      }
    }
    // semi-implicit Euler, rows r and r + NV
    const S a_r = pick<NV>(acc, r), x1 = pick<NDX>(x, r), x2 = pick<NDX>(x, r2);
    store(run, O::oXn + r, a.xnext + (t * NDX + r) * TB + b, x1 + x2 * dt + a_r * dt * dt);
    store(run, O::oXn + r2, a.xnext + (t * NDX + r2) * TB + b, x2 + a_r * dt);
  }

  fin = grp.all(fin);
  if (live && lane == 0) {
    if (terminal) {
      a.tcost[b] = c;
      a.tok[b] = fin;
    } else {
      a.cost[t * TB + b] = c;
      a.ok[t * TB + b] = fin;
    }
  }
  if constexpr (kStageOut) {  // the block's tile out along the batch axis: a
    // thread takes one group's column s, every (THREADS / SPB)-th element
    static_assert(kLinThreads % O::SPB == 0, "whole columns a thread");
    constexpr int STEP = kLinThreads / O::SPB;
    __syncthreads();
    const int s = threadIdx.x % O::SPB, e0 = threadIdx.x / O::SPB;
    const long long nn = (long long)blockIdx.x * O::SPB + s, tt = nn / TB, bb = nn % TB;
    const bool last = tt == a.T;
    // (array, its first element in the tile); the terminal knot only Lx, Lxx
    S* const dst[] = {a.Fx, a.Fu, a.Lx, a.Lu, a.Lxx, a.Lxu, a.Luu, a.xnext};
    const int off[] = {O::oFx, O::oFu, O::oLx, O::oLu, O::oLxx, O::oLxu, O::oLuu, O::oXn, O::E};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n_k = off[k + 1] - off[k];
      if (nn >= N || (last && k != 2 && k != 4)) continue;
      S* const base = (last ? (k == 2 ? a.tLx : a.tLxx) : dst[k] + tt * n_k * TB) + bb;
      for (int e = ((e0 - off[k]) % STEP + STEP) % STEP; e < n_k; e += STEP)
        base[e * TB] = tile[(off[k] + e) * O::P + s];
    }
  }
}

template <class S, int NL, bool SEA, int TAB>
__global__ void __launch_bounds__(kLinThreads) linearize_kernel(const VSAParams<NL> P,
                                                                const Lin<S> a) {
  linearize_group<S, NL, SEA, kLinGroup, TAB>(P, a);
}

template <class S, int NL, bool SEA, int TAB>
static int launch_arm(const VSAParams<NL>& P, const Lin<S>& a, cudaStream_t stream) {
  using O = LinOut<Arm<NL, SEA>::NDX, Arm<NL, SEA>::NU, kLinGroup>;
  const long long threads = (long long)(a.T + 1) * a.B * kLinGroup;
  const int grid = (int)((threads + kLinThreads - 1) / kLinThreads);
  const int smem = (int)O::BYTES(sizeof(S));
  static const cudaError_t attr = cudaFuncSetAttribute(
      linearize_kernel<S, NL, SEA, TAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  linearize_kernel<S, NL, SEA, TAB><<<grid, kLinThreads, smem, stream>>>(P, a);
  return (int)cudaGetLastError();
}

// at NL = 2 the target table has instances of its own (the shared ones
// carry no table branch); above, one instance takes either by a uniform
// branch
template <class S, int NL, bool SEA>
static int launch_tables(const VSAParams<NL>& P, const Lin<S>& a, cudaStream_t st) {
  if constexpr (NL != 2) {
    return launch_arm<S, NL, SEA, kEither>(P, a, st);
  } else {
    if (a.tgt) return launch_arm<S, NL, SEA, kTables>(P, a, st);
    return launch_arm<S, NL, SEA, kShared>(P, a, st);
  }
}

// the launch at the chain length NL of the including unit: the SEA
// instance at every NL, the VSA one at NL = 2 only (an n-DoF VSA preset
// comes later); kNoInstance for another nl or actuation
template <class S, int NL>
static int launch_linearize(const double* params, int nl, const Lin<S>& a, void* stream) {
  if (nl != NL) return kNoInstance;
  const VSAParams<NL> P = unpack_params<NL>(params);
  cudaStream_t st = (cudaStream_t)stream;
  if (P.sea) return launch_tables<S, NL, true>(P, a, st);
  if constexpr (NL == 2) return launch_tables<S, NL, false>(P, a, st);
  return kNoInstance;
}

}  // namespace aslr

// one C entry a scalar type: NAME launches K1 at the chain length NL
#define ASLR_LINEARIZE_ENTRY(NAME, S, NL)                                                \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us,            \
                      const S* wterm, const S* tgt, int T, int B, S* Fx, S* Fu, S* Lx,  \
                      S* Lu, S* Lxx, S* Lxu, S* Luu, S* xnext, S* cost, bool* ok,       \
                      S* tLx, S* tLxx, S* tcost, bool* tok, void* stream) {             \
    aslr::Lin<S> a{xs,  us,  wterm, tgt,   T,    B,  Fx,  Fu,   Lx,  Lu, Lxx,           \
                   Lxu, Luu, xnext, cost, ok, tLx, tLxx, tcost, tok};                   \
    return aslr::launch_linearize<S, NL>(params, nl, a, stream);                        \
  }
