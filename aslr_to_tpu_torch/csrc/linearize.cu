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
// derivatives, and a finiteness flag over the derivative tensors.
//
// Thread mapping: one thread per (knot, scenario), the terminal knot
// included as knot T, so one launch covers the whole linearization;
// T = 100 and B = 4096 give 413,696 threads. The knots are independent,
// which makes this the one kernel of the slice with parallelism well
// beyond one thread per scenario.
//
// What bounds it on the H100: each running VSA knot writes 228 values
// (Fx 64, Fu 32, Lx 8, Lu 4, Lxx 64, Lxu 32, Luu 16, xnext 8) plus cost and
// flag, 0.92 KB in f32 and 1.8 KB in f64, so the output stream is 377 MB in
// f32 at the main-path shape: about 0.11 ms at 3.35 TB/s (the SEA knot
// writes 194 values: nu = 2). The arithmetic
// is about 7 RNEA sweeps (3 plain, 4 dual) and 3 dual log6 evaluations,
// a few thousand flops per knot, serial within the thread. The dual-number
// state in f64 presses on registers. This first version writes the
// constant tensors (Lxu = 0, diagonal Luu) too, to keep the kernel's
// interface equal to the Pallas kernel's; it is right first and not yet
// fast: nothing is shared between the threads of a scenario and the
// constant outputs cost bandwidth.
#include "lanes.cuh"

namespace aslr {

template <class S, int NL, bool SEA>
__global__ void linearize_kernel(VSAParams<NL> P, const S* __restrict__ xs,
                                 const S* __restrict__ us, const S* __restrict__ wterm,
                                 int T, int B, S* __restrict__ Fx, S* __restrict__ Fu,
                                 S* __restrict__ Lx, S* __restrict__ Lu, S* __restrict__ Lxx,
                                 S* __restrict__ Lxu, S* __restrict__ Luu,
                                 S* __restrict__ xnext, S* __restrict__ cost,
                                 bool* __restrict__ ok, S* __restrict__ tLx,
                                 S* __restrict__ tLxx, S* __restrict__ tcost,
                                 bool* __restrict__ tok) {
  constexpr int NDX = Arm<NL, SEA>::NDX;
  constexpr int NU = Arm<NL, SEA>::NU;
  constexpr int NV = 2 * NL;
  typedef Dual<S> D;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)(T + 1) * B) return;
  const int t = (int)(n / B);
  const int b = (int)(n % B);
  const bool terminal = (t == T);
  const long long TB = (long long)B;

  S x[NDX], u[NU];
  for (int i = 0; i < NDX; ++i) x[i] = xs[((long long)t * NDX + i) * TB + b];
  for (int j = 0; j < NU; ++j) u[j] = terminal ? S(0) : us[((long long)t * NU + j) * TB + b];
  const S* q_l = x;
  const S* q_m = x + NL;
  const S* v_l = x + 2 * NL;

  // goal residual and its Jacobian wrt q_l (NL dual seeds; r6 from the values)
  S r6[6], J[NL][6];
  S c_goal = S(0);
  for (int j = 0; j < NL; ++j) {
    D qd[NL], rd[6];
    for (int i = 0; i < NL; ++i) qd[i] = D(q_l[i], S(i == j ? 1 : 0));
    D cd = goal_cost<D, NL>(P, qd, terminal, rd);
    for (int k = 0; k < 6; ++k) J[j][k] = rd[k].d;
    if (j == 0) {
      c_goal = cd.v;
      for (int k = 0; k < 6; ++k) r6[k] = rd[k].v;
    }
  }
  const S w_goal = terminal ? wterm[b] : S(P.w_goal);

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

  bool fin = true;
  S lx[NDX];
  for (int i = 0; i < NDX; ++i) {
    S v = S(0);
    if (i < NL)
      for (int k = 0; k < 6; ++k) v = v + w_goal * J[i][k] * r6[k];
    if (!terminal && P.xw[i] != 0.0) v = v + S(P.xw[i]) * x[i];
    lx[i] = v;
    fin = fin && finite(v);
  }
  S lxx[NDX][NDX];
  for (int i = 0; i < NDX; ++i)
    for (int j = 0; j < NDX; ++j) {
      S v = S(0);
      if (i < NL && j < NL)
        for (int k = 0; k < 6; ++k) v = v + w_goal * J[i][k] * J[j][k];
      if (i == j && !terminal && P.xw[i] != 0.0) v = v + S(P.xw[i]);
      lxx[i][j] = v;
      fin = fin && finite(v);
    }

  if (terminal) {
    for (int i = 0; i < NDX; ++i) tLx[i * TB + b] = lx[i];
    for (int i = 0; i < NDX; ++i)
      for (int j = 0; j < NDX; ++j) tLxx[(i * NDX + j) * TB + b] = lxx[i][j];
    tcost[b] = c;
    tok[b] = fin;
    return;
  }

  const long long kt = (long long)t;
  cost[kt * TB + b] = c;
  for (int i = 0; i < NDX; ++i) Lx[(kt * NDX + i) * TB + b] = lx[i];
  for (int i = 0; i < NDX; ++i)
    for (int j = 0; j < NDX; ++j) Lxx[((kt * NDX + i) * NDX + j) * TB + b] = lxx[i][j];
  for (int j = 0; j < NU; ++j) {
    S v = S(0);
    if (P.uw[j] != 0.0) v = v + S(P.uw[j]) * u[j];
    if constexpr (!SEA) {
      if (P.stiff_w != 0.0 && j >= NL) v = v + S(P.stiff_w);
    }
    Lu[(kt * NU + j) * TB + b] = v;
    fin = fin && finite(v);
  }
  for (int i = 0; i < NDX; ++i)
    for (int j = 0; j < NU; ++j) Lxu[((kt * NDX + i) * NU + j) * TB + b] = S(0);
  for (int i = 0; i < NU; ++i)
    for (int j = 0; j < NU; ++j) {
      S v = S(0);
      if (i == j && P.uw[i] != 0.0) v = v + S(P.uw[i]);
      Luu[((kt * NU + i) * NU + j) * TB + b] = v;
    }

  // -- dynamics and the analytic acceleration Jacobians ---------------------
  S M[NL][NL], tau_c[NL], a[NV];
  arm_dynamics<S, NL, SEA>(P, x, u, a, M, tau_c);

  // cols[c][r]: d a_r / d input_c, inputs [q_l, q_m, v_l, v_m, tau] and,
  // for the VSA, [k]
  S cols[NDX + NU][NV];
  S Minv[NL][NL];
  S Lfac[NL][NL];
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
  auto msolve = [&](const S* col, S* out) {
    if constexpr (NL == 2) {
      out[0] = Minv[0][0] * col[0] + Minv[0][1] * col[1];
      out[1] = Minv[1][0] * col[0] + Minv[1][1] * col[1];
    } else {
      choln_solve<S, NL>(Lfac, col, out);
    }
  };
  auto binv_apply = [&](const S* col, S* out) {
    for (int i = 0; i < NL; ++i) {
      S acc = S(P.binv[i][0]) * col[0];
      for (int j = 1; j < NL; ++j) acc = acc + S(P.binv[i][j]) * col[j];
      out[i] = acc;
    }
  };

  // RNEA partials at (q_l, v_l, a_l): dtau/dq_j and dtau/dv_j
  S dtau_dq[NL][NL], dtau_dv[NL][NL];
  for (int j = 0; j < NL; ++j) {
    D qd[NL], vd[NL], ad[NL], tq[NL], tv[NL];
    for (int i = 0; i < NL; ++i) {
      qd[i] = D(q_l[i], S(i == j ? 1 : 0));
      vd[i] = D(v_l[i]);
      ad[i] = D(a[i]);
    }
    rnea<D, NL>(P, qd, vd, ad, true, tq);
    for (int i = 0; i < NL; ++i) {
      qd[i] = D(q_l[i]);
      vd[i] = D(v_l[i], S(i == j ? 1 : 0));
    }
    rnea<D, NL>(P, qd, vd, ad, true, tv);
    for (int i = 0; i < NL; ++i) {
      dtau_dq[j][i] = tq[i].d;
      dtau_dv[j][i] = tv[i].d;
    }
  }

  for (int j = 0; j < NL; ++j) {
    // dK[i] = d tau_c_i / d q_l_j: the VSA's k_j on the diagonal, or the
    // SEA's spring column K[:, j]
    S dK[NL], tmp[NL], link[NL], mot[NL];
    for (int i = 0; i < NL; ++i) {
      if constexpr (SEA)
        dK[i] = S(P.K[i][j]);
      else
        dK[i] = (i == j) ? u[NL + j] : S(0);
    }
    // d a / d q_l_j
    for (int i = 0; i < NL; ++i) tmp[i] = -(dtau_dq[j][i]) - dK[i];
    msolve(tmp, link);
    binv_apply(dK, mot);
    for (int i = 0; i < NL; ++i) {
      cols[j][i] = link[i];
      cols[j][NL + i] = mot[i];
    }
    // d a / d q_m_j (the spring's sign flips)
    msolve(dK, link);
    for (int i = 0; i < NL; ++i) {
      cols[NL + j][i] = link[i];
      cols[NL + j][NL + i] = -mot[i];
    }
    // d a / d v_l_j
    for (int i = 0; i < NL; ++i) tmp[i] = -dtau_dv[j][i];
    msolve(tmp, link);
    for (int i = 0; i < NL; ++i) {
      cols[2 * NL + j][i] = link[i];
      cols[2 * NL + j][NL + i] = S(0);
    }
    // d a / d v_m_j
    for (int i = 0; i < NV; ++i) cols[3 * NL + j][i] = S(0);
    // d a / d tau_j
    for (int i = 0; i < NL; ++i) {
      cols[4 * NL + j][i] = S(0);
      cols[4 * NL + j][NL + i] = S(P.binv[i][j]);
    }
    // d a / d k_j (VSA only)
    if constexpr (!SEA) {
      S d = q_l[j] - q_m[j];
      if constexpr (NL == 2) {
        for (int i = 0; i < NL; ++i) link[i] = Minv[i][j] * -d;
      } else {
        for (int i = 0; i < NL; ++i) tmp[i] = (i == j) ? -d : S(0);
        msolve(tmp, link);
      }
      for (int i = 0; i < NL; ++i) {
        cols[5 * NL + j][i] = link[i];
        cols[5 * NL + j][NL + i] = S(P.binv[i][j]) * d;
      }
    }
  }

  // -- Euler chain rule ----------------------------------------------------
  const S dt = S(P.dt);
  const S dt2 = S(P.dt * P.dt);
  for (int i = 0; i < NDX; ++i)
    for (int j = 0; j < NDX; ++j) {
      S v;
      if (i < NV) {
        v = cols[j][i] * dt2;
        if (i == j) v = v + S(1);
        if (j == i + NV) v = v + dt;
      } else {
        v = cols[j][i - NV] * dt;
        if (i == j) v = v + S(1);
      }
      Fx[((kt * NDX + i) * NDX + j) * TB + b] = v;
      fin = fin && finite(v);
    }
  for (int i = 0; i < NDX; ++i)
    for (int j = 0; j < NU; ++j) {
      const S* col = cols[NDX + j];
      S v = (i < NV) ? col[i] * dt2 : col[i - NV] * dt;
      Fu[((kt * NDX + i) * NU + j) * TB + b] = v;
      fin = fin && finite(v);
    }
  ok[kt * TB + b] = fin;

  S xn[NDX];
  euler<S, NL>(P.dt, x, a, xn);
  for (int i = 0; i < NDX; ++i) xnext[(kt * NDX + i) * TB + b] = xn[i];
}

template <class S>
static int launch_linearize(const double* params, int nl, const S* xs, const S* us,
                            const S* wterm, int T, int B, S* Fx, S* Fu, S* Lx, S* Lu,
                            S* Lxx, S* Lxu, S* Luu, S* xnext, S* cost, bool* ok, S* tLx,
                            S* tLxx, S* tcost, bool* tok, void* stream) {
  if (nl != 2) return -1;
  VSAParams<2> P = unpack_params<2>(params);
  long long n = (long long)(T + 1) * B;
  if (P.sea)
    linearize_kernel<S, 2, true><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        P, xs, us, wterm, T, B, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost, ok, tLx, tLxx,
        tcost, tok);
  else
    linearize_kernel<S, 2, false><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        P, xs, us, wterm, T, B, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost, ok, tLx, tLxx,
        tcost, tok);
  return (int)cudaGetLastError();
}

}  // namespace aslr

#define ASLR_LINEARIZE_ENTRY(NAME, S)                                                    \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us,            \
                      const S* wterm, int T, int B, S* Fx, S* Fu, S* Lx, S* Lu, S* Lxx, \
                      S* Lxu, S* Luu, S* xnext, S* cost, bool* ok, S* tLx, S* tLxx,     \
                      S* tcost, bool* tok, void* stream) {                              \
    return aslr::launch_linearize<S>(params, nl, xs, us, wterm, T, B, Fx, Fu, Lx, Lu,   \
                                     Lxx, Lxu, Luu, xnext, cost, ok, tLx, tLxx, tcost,   \
                                     tok, stream);                                      \
  }

ASLR_LINEARIZE_ENTRY(aslr_linearize_f32, float)
ASLR_LINEARIZE_ENTRY(aslr_linearize_f64, double)
