// K4: the FDDP backward Riccati sweep with Cholesky gains (FDDP, and DDP
// with zero gaps).
//
// Replaces the Pallas kernel aslr_to_tpu/pallas/riccati.py::
// _riccati_fddp_kernel with boxed=False (launched through
// prepare_riccati_fddp_backward_lanes). Per scenario:
//   terminal node: Vxx_T = tLxx + reg I, w_T = Vxx_T fs_T, Vx_T = tLx + w_T;
//   knots T-1 .. 0: the Q terms from (Vx, Vxx), Quu + reg I; the gains
//   k, K from a Cholesky of Quu; the value update, symmetrized, plus reg;
//   the deflection w_t = Vxx_t fs_t, and Vx += w_t (Crocoddyl's
//   SolverFDDP::backwardPass);
//   the sums dg, dq, stop and the gap terms dg_gap = -sum Vx.fs,
//   dq_gap = sum fs.w, and the flags ok and retryable (K2's taxonomy: a
//   failure whose Quu was still finite is retryable with more reg).
// Outputs k [T,nu,B], K [T,nu,ndx,B] and w [T+1,ndx,B] in lane layout.
// (boxed=True, K5, is K2's group kernel with gaps: riccati_box.cu.)
//
// Thread mapping: one thread per scenario, the knot loop serial inside it.
// Per knot a thread reads 2 ndx^2 + 2 ndx nu + nu^2 + 2 ndx + nu
// derivative values plus ndx gaps and writes nu + nu ndx + ndx: at the SEA
// shape (ndx 8, nu 2) about 208 values, 0.83 KB in f32. The work is about
// 2.5 kflop of dependent 8x8 products per knot. What bounds it is latency
// and registers: the value carry (Vx, Vxx: 72 values) and the Q blocks live
// in the thread, and the derivatives are read from global memory inside the
// products. K2/K5's design (a group of lanes a scenario, knot inputs staged
// in shared memory) is the model for its redesign.
#include "boxqp.cuh"

namespace aslr {

template <class S, int NDX, int NU>
__global__ void riccati_fddp_kernel(const S* __restrict__ Fx, const S* __restrict__ Fu,
                                    const S* __restrict__ Lx, const S* __restrict__ Lu,
                                    const S* __restrict__ Lxx, const S* __restrict__ Lxu,
                                    const S* __restrict__ Luu, const S* __restrict__ tLx,
                                    const S* __restrict__ tLxx, const S* __restrict__ fs,
                                    const S* __restrict__ reg_in, int T, int B,
                                    S* __restrict__ k_out, S* __restrict__ K_out,
                                    S* __restrict__ w_out, S* __restrict__ dg_out,
                                    S* __restrict__ dq_out, S* __restrict__ stop_out,
                                    S* __restrict__ dgg_out, S* __restrict__ dqg_out,
                                    bool* __restrict__ ok_out, bool* __restrict__ retry_out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long TB = (long long)B;
  const S reg = reg_in[b];

  // terminal node
  S Vx[NDX], Vxx[NDX][NDX], f[NDX];
  for (int i = 0; i < NDX; ++i) {
    f[i] = fs[((long long)T * NDX + i) * TB + b];
    for (int j = 0; j < NDX; ++j) {
      Vxx[i][j] = tLxx[(i * NDX + j) * TB + b];
      if (i == j) Vxx[i][j] = Vxx[i][j] + reg;
    }
  }
  S dgg, dqg;
  {
    S w[NDX];
    for (int i = 0; i < NDX; ++i) {
      S acc = Vxx[i][0] * f[0];
      for (int j = 1; j < NDX; ++j) acc = acc + Vxx[i][j] * f[j];
      w[i] = acc;
      w_out[((long long)T * NDX + i) * TB + b] = acc;
      Vx[i] = tLx[i * TB + b] + acc;
    }
    S s1 = Vx[0] * f[0], s2 = f[0] * w[0];
    for (int i = 1; i < NDX; ++i) {
      s1 = s1 + Vx[i] * f[i];
      s2 = s2 + f[i] * w[i];
    }
    dgg = -s1;
    dqg = s2;
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

    // gains: k = Quu^-1 Qu, K = Quu^-1 Qxu^T
    S k[NU], Kg[NU][NDX], L[NU][NU];
    chol<S, NU>(Quu, L);
    chol_solve<S, NU>(L, Qu, k);
    for (int c = 0; c < NDX; ++c) {
      S rhs[NU], sol[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = Qxu[c][i];
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
    // FDDP deflection w_t = Vxx_t fs_t; Vx += w_t
    S w[NDX];
    for (int i = 0; i < NDX; ++i) f[i] = fs[(kt * NDX + i) * TB + b];
    for (int i = 0; i < NDX; ++i) {
      S acc = Vxx[i][0] * f[0];
      for (int j = 1; j < NDX; ++j) acc = acc + Vxx[i][j] * f[j];
      w[i] = acc;
      w_out[(kt * NDX + i) * TB + b] = acc;
      Vx[i] = Vx[i] + acc;
      out_ok = out_ok && finite(Vx[i]);
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
    S s1 = Vx[0] * f[0], s2 = f[0] * w[0];
    for (int i = 1; i < NDX; ++i) {
      s1 = s1 + Vx[i] * f[i];
      s2 = s2 + f[i] * w[i];
    }
    dg = dg + sg;
    dq = dq - sq;
    stop = stop + ss;
    dgg = dgg - s1;
    dqg = dqg + s2;
  }
  bool ok = finite(dg) && finite(stop);
  for (int i = 0; i < NDX; ++i) ok = ok && finite(Vx[i]);
  dg_out[b] = dg;
  dq_out[b] = dq;
  stop_out[b] = stop;
  dgg_out[b] = dgg;
  dqg_out[b] = dqg;
  ok_out[b] = ok;
  retry_out[b] = indef;
}

template <class S>
static int launch_riccati_fddp(int ndx, int nu, const S* Fx, const S* Fu, const S* Lx,
                               const S* Lu, const S* Lxx, const S* Lxu, const S* Luu,
                               const S* tLx, const S* tLxx, const S* fs, const S* reg, int T,
                               int B, S* k, S* K, S* w, S* dg, S* dq, S* stop, S* dgg, S* dqg,
                               bool* ok, bool* retryable, void* stream) {
  if (ndx != 8 || (nu != 2 && nu != 4)) return -1;
#define ASLR_FDDP_CASE(NU_)                                                                 \
  riccati_fddp_kernel<S, 8, NU_><<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(            \
      Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg, T, B, k, K, w, dg, dq, stop, dgg, dqg, \
      ok, retryable)
  if (nu == 2) ASLR_FDDP_CASE(2);
  else ASLR_FDDP_CASE(4);
#undef ASLR_FDDP_CASE
  return (int)cudaGetLastError();
}

}  // namespace aslr

#define ASLR_RICCATI_FDDP_ENTRY(NAME, S)                                                      \
  extern "C" int NAME(int ndx, int nu, const S* Fx, const S* Fu, const S* Lx, const S* Lu,    \
                      const S* Lxx, const S* Lxu, const S* Luu, const S* tLx, const S* tLxx,  \
                      const S* fs, const S* reg, int T, int B, S* k, S* K, S* w, S* dg,       \
                      S* dq, S* stop, S* dgg, S* dqg, bool* ok, bool* retryable,              \
                      void* stream) {                                                         \
    return aslr::launch_riccati_fddp<S>(ndx, nu, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx,    \
                                        fs, reg, T, B, k, K, w, dg, dq, stop, dgg, dqg, ok,   \
                                        retryable, stream);                                   \
  }

ASLR_RICCATI_FDDP_ENTRY(aslr_riccati_fddp_f32, float)
ASLR_RICCATI_FDDP_ENTRY(aslr_riccati_fddp_f64, double)
