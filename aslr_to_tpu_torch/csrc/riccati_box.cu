// K2: Box-DDP backward Riccati sweep with a projected-Newton BoxQP per knot.
//
// Replaces the Pallas kernel aslr_to_tpu/pallas/riccati.py::
// _riccati_box_kernel (launched by prepare_riccati_box_backward_lanes) with
// its helpers _boxqp_lanes, _masked_chol_solve, _chol4 and _chol4_solve.
// Per scenario, over the knots T-1 .. 0:
//   Q terms from (Vx, Vxx), Quu + reg I;
//   a masked projected-Newton BoxQP on the box (lb - u, ub - u), started
//   from -kprev (warm) or 0 (cold): qp_iters iterations, each a masked
//   Cholesky Newton step and a 5-step Armijo search;
//   the free-subspace gains K from a masked Cholesky;
//   the value update with symmetrization and reg;
//   the sums dg, dq, stop, and the flags ok and retryable.
//
// Thread mapping: one thread per scenario, the knot loop serial inside it
// (the Riccati recursion is sequential by the math). At B = 4096 that is
// 32 blocks of 128 threads on 132 SMs, so most of the card idles. Per
// knot a thread reads the 228 derivative values and writes 36 gain
// values; the work is about 3 kflop (the 8x8 products dominate) plus the
// QP, all dependent. What bounds it is latency and registers: the value
// carry (Vxx, 64 values) and the Q blocks live in the thread, which spills
// in f64. Right first, not fast: splitting a scenario's matrix products
// across a warp is later work. The BoxQP and the small Cholesky helpers
// are shared with K5 (boxqp.cuh).
#include "boxqp.cuh"

namespace aslr {

template <class S, int NDX, int NU>
__global__ void riccati_box_kernel(const S* __restrict__ Fx, const S* __restrict__ Fu,
                                   const S* __restrict__ Lx, const S* __restrict__ Lu,
                                   const S* __restrict__ Lxx, const S* __restrict__ Lxu,
                                   const S* __restrict__ Luu, const S* __restrict__ tLx,
                                   const S* __restrict__ tLxx, const S* __restrict__ us,
                                   const S* __restrict__ kprev, const S* __restrict__ lb,
                                   const S* __restrict__ ub, const S* __restrict__ reg_in,
                                   int T, int B, int qp_iters, S* __restrict__ k_out,
                                   S* __restrict__ K_out, S* __restrict__ dg_out,
                                   S* __restrict__ dq_out, S* __restrict__ stop_out,
                                   bool* __restrict__ ok_out, bool* __restrict__ retry_out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long TB = (long long)B;
  const S reg = reg_in[b];
  S lo[NU], hi[NU];
  for (int j = 0; j < NU; ++j) {
    lo[j] = lb[j * TB + b];
    hi[j] = ub[j * TB + b];
  }
  S Vx[NDX], Vxx[NDX][NDX];
  for (int i = 0; i < NDX; ++i) {
    Vx[i] = tLx[i * TB + b];
    for (int j = 0; j < NDX; ++j) {
      Vxx[i][j] = tLxx[(i * NDX + j) * TB + b];
      if (i == j) Vxx[i][j] = Vxx[i][j] + reg;
    }
  }
  S dg = S(0), dq = S(0), stop = S(0);
  bool indef = false;

  for (int t = T - 1; t >= 0; --t) {
    const long long kt = t;
    auto fx = [&](int r, int c) { return Fx[((kt * NDX + r) * NDX + c) * TB + b]; };
    auto fu = [&](int r, int c) { return Fu[((kt * NDX + r) * NU + c) * TB + b]; };

    S Qx[NDX], Qu[NU];
    for (int n = 0; n < NDX; ++n) {
      S acc = fx(0, n) * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + fx(m, n) * Vx[m];
      Qx[n] = Lx[(kt * NDX + n) * TB + b] + acc;
    }
    for (int n = 0; n < NU; ++n) {
      S acc = fu(0, n) * Vx[0];
      for (int m = 1; m < NDX; ++m) acc = acc + fu(m, n) * Vx[m];
      Qu[n] = Lu[(kt * NU + n) * TB + b] + acc;
    }
    // FxTVxx = Fx^T Vxx, FuTVxx = Fu^T Vxx
    S FxTVxx[NDX][NDX], FuTVxx[NU][NDX];
    for (int n = 0; n < NDX; ++n)
      for (int m = 0; m < NDX; ++m) {
        S acc = fx(0, n) * Vxx[0][m];
        for (int r = 1; r < NDX; ++r) acc = acc + fx(r, n) * Vxx[r][m];
        FxTVxx[n][m] = acc;
      }
    for (int n = 0; n < NU; ++n)
      for (int m = 0; m < NDX; ++m) {
        S acc = fu(0, n) * Vxx[0][m];
        for (int r = 1; r < NDX; ++r) acc = acc + fu(r, n) * Vxx[r][m];
        FuTVxx[n][m] = acc;
      }
    // Qxu = Lxu + FxTVxx Fu, Quu = Luu + FuTVxx Fu + reg I
    S Qxu[NDX][NU], Quu[NU][NU];
    for (int n = 0; n < NDX; ++n)
      for (int m = 0; m < NU; ++m) {
        S acc = FxTVxx[n][0] * fu(0, m);
        for (int r = 1; r < NDX; ++r) acc = acc + FxTVxx[n][r] * fu(r, m);
        Qxu[n][m] = Lxu[((kt * NDX + n) * NU + m) * TB + b] + acc;
      }
    bool quu_ok = true;
    for (int n = 0; n < NU; ++n)
      for (int m = 0; m < NU; ++m) {
        S acc = FuTVxx[n][0] * fu(0, m);
        for (int r = 1; r < NDX; ++r) acc = acc + FuTVxx[n][r] * fu(r, m);
        S v = Luu[((kt * NU + n) * NU + m) * TB + b] + acc;
        if (n == m) v = v + reg;
        Quu[n][m] = v;
        quu_ok = quu_ok && finite(v);
      }

    // box QP on du in (lb - u, ub - u), warm-started from -kprev
    S low[NU], up[NU], du[NU], free[NU];
    for (int j = 0; j < NU; ++j) {
      const S u_t = us[(kt * NU + j) * TB + b];
      low[j] = lo[j] - u_t;
      up[j] = hi[j] - u_t;
      du[j] = kprev ? -kprev[(kt * NU + j) * TB + b] : S(0);
    }
    boxqp<S, NU>(Quu, Qu, low, up, qp_iters, du, free);
    S k[NU];
    for (int j = 0; j < NU; ++j) k[j] = -du[j];

    // free-subspace gains: K = masked solve of Quu with Qxu^T
    S L[NU][NU], Kg[NU][NDX];
    masked_factor<S, NU>(Quu, free, L);
    for (int c = 0; c < NDX; ++c) {
      S rhs[NU], sol[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = Qxu[c][i] * free[i];
      chol_solve<S, NU>(L, rhs, sol);
      for (int i = 0; i < NU; ++i) Kg[i][c] = sol[i];
    }

    // value update: Vx = Qx + K^T Quu k - 2 K^T Qu; Vxx = sym(Qxx - Qxu K) + reg I
    S Quuk[NU];
    for (int i = 0; i < NU; ++i) {
      S acc = Quu[i][0] * k[0];
      for (int j = 1; j < NU; ++j) acc = acc + Quu[i][j] * k[j];
      Quuk[i] = acc;
    }
    bool out_ok = true;
    for (int j = 0; j < NU; ++j) out_ok = out_ok && finite(k[j]);
    for (int n = 0; n < NDX; ++n) {
      S a1 = Kg[0][n] * Quuk[0], a2 = Kg[0][n] * Qu[0];
      for (int i = 1; i < NU; ++i) {
        a1 = a1 + Kg[i][n] * Quuk[i];
        a2 = a2 + Kg[i][n] * Qu[i];
      }
      Vx[n] = Qx[n] + a1 - S(2) * a2;
      out_ok = out_ok && finite(Vx[n]);
      for (int i = 0; i < NU; ++i) out_ok = out_ok && finite(Kg[i][n]);
    }
    // Qxx - Qxu K, with Qxx = Lxx + FxTVxx Fx (into Vxx, which is consumed)
    for (int n = 0; n < NDX; ++n)
      for (int m = 0; m < NDX; ++m) {
        S acc = FxTVxx[n][0] * fx(0, m);
        for (int r = 1; r < NDX; ++r) acc = acc + FxTVxx[n][r] * fx(r, m);
        S qk = Qxu[n][0] * Kg[0][m];
        for (int i = 1; i < NU; ++i) qk = qk + Qxu[n][i] * Kg[i][m];
        Vxx[n][m] = (Lxx[((kt * NDX + n) * NDX + m) * TB + b] + acc) - qk;
      }
    for (int n = 0; n < NDX; ++n)
      for (int m = n; m < NDX; ++m) {
        S s = S(0.5) * (Vxx[n][m] + Vxx[m][n]);
        Vxx[n][m] = s;
        Vxx[m][n] = s;
      }
    for (int n = 0; n < NDX; ++n) {
      Vxx[n][n] = Vxx[n][n] + reg;
      for (int m = 0; m < NDX; ++m) out_ok = out_ok && finite(Vxx[n][m]);
    }
    indef = indef || (quu_ok && !out_ok);

    for (int j = 0; j < NU; ++j) {
      k_out[(kt * NU + j) * TB + b] = k[j];
      for (int c = 0; c < NDX; ++c) K_out[((kt * NU + j) * NDX + c) * TB + b] = Kg[j][c];
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
  }
  bool ok = finite(dg) && finite(dq) && finite(stop);
  for (int i = 0; i < NDX; ++i) ok = ok && finite(Vx[i]);
  dg_out[b] = dg;
  dq_out[b] = dq;
  stop_out[b] = stop;
  ok_out[b] = ok;
  retry_out[b] = indef;
}

template <class S>
static int launch_riccati_box(int ndx, int nu, const S* Fx, const S* Fu, const S* Lx,
                              const S* Lu, const S* Lxx, const S* Lxu, const S* Luu,
                              const S* tLx, const S* tLxx, const S* us, const S* kprev,
                              const S* lb, const S* ub, const S* reg, int T, int B,
                              int qp_iters, S* k, S* K, S* dg, S* dq, S* stop, bool* ok,
                              bool* retryable, void* stream) {
  if (ndx != 8 || nu != 4) return -1;
  riccati_box_kernel<S, 8, 4><<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, us, kprev, lb, ub, reg, T, B, qp_iters, k, K,
      dg, dq, stop, ok, retryable);
  return (int)cudaGetLastError();
}

}  // namespace aslr

#define ASLR_RICCATI_ENTRY(NAME, S)                                                        \
  extern "C" int NAME(int ndx, int nu, const S* Fx, const S* Fu, const S* Lx, const S* Lu, \
                      const S* Lxx, const S* Lxu, const S* Luu, const S* tLx,              \
                      const S* tLxx, const S* us, const S* kprev, const S* lb,             \
                      const S* ub, const S* reg, int T, int B, int qp_iters, S* k, S* K,   \
                      S* dg, S* dq, S* stop, bool* ok, bool* retryable, void* stream) {    \
    return aslr::launch_riccati_box<S>(ndx, nu, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx,  \
                                       us, kprev, lb, ub, reg, T, B, qp_iters, k, K, dg,   \
                                       dq, stop, ok, retryable, stream);                   \
  }

ASLR_RICCATI_ENTRY(aslr_riccati_box_f32, float)
ASLR_RICCATI_ENTRY(aslr_riccati_box_f64, double)
