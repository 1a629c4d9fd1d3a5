// Small dense linear algebra, per thread, shared by the backward Riccati
// kernels (K2/K5 in riccati_box.cu, K4 in riccati_fddp.cu), and the masked
// projected-Newton BoxQP of K2/K5 over a group of lanes that holds one
// scenario.
//
// Replaces the helpers of aslr_to_tpu/pallas/riccati.py: _chol4,
// _chol4_solve, _masked_chol_solve and _boxqp_lanes. Every sum runs in the
// order of its plain twin in aslr_to_tpu_torch/kernels/riccati.py.
#pragma once

#include "common.cuh"

namespace aslr {

// a / b, or, with SKIP0 and a zero dividend over a finite nonzero divisor,
// a * b: the same signed zero without the division, whose slow path a zero
// dividend takes. The masked systems of the BoxQP (a clamped control's row
// and column are zero) divide zeros at every knot.
template <bool SKIP0, class S>
__device__ inline S div0(S a, S b, bool b_regular) {
  if (SKIP0 && a == S(0) && b_regular) return a * b;
  return a / b;
}

template <class S>
__device__ inline bool regular(S b) { return b != S(0) && finite(b); }

template <class S, int N, bool SKIP0 = false>
__device__ inline void chol(const S (&A)[N][N], S (&L)[N][N]) {
  bool reg[N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j) {
      S s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = dsqrt(s);
        reg[i] = SKIP0 && regular(L[i][i]);
      } else {
        L[i][j] = div0<SKIP0>(s, L[j][j], reg[j]);
      }
    }
}

template <class S, int N, bool SKIP0 = false>
__device__ inline void chol_solve(const S (&L)[N][N], const S* b, S* x) {
  bool reg[N];
  for (int i = 0; i < N; ++i) reg[i] = SKIP0 && regular(L[i][i]);
  S y[N];
  for (int i = 0; i < N; ++i) {
    S s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = div0<SKIP0>(s, L[i][i], reg[i]);
  }
  for (int i = N - 1; i >= 0; --i) {
    S s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = div0<SKIP0>(s, L[i][i], reg[i]);
  }
}

// masked system: clamped rows/columns replaced by identity (riccati.py::
// _masked_chol_solve), whose zero rows the factor's divisions skip
template <class S, int N>
__device__ inline void masked_factor(const S (&Quu)[N][N], const S* free, S (&L)[N][N]) {
  S A[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      A[i][j] = Quu[i][j] * (free[i] * free[j]);
      if (i == j) A[i][j] = A[i][j] + (S(1) - free[i]);
    }
  chol<S, N, true>(A, L);
}

template <class S, int N>
__device__ inline S quad(const S (&H)[N][N], const S* q, const S* x) {
  // 0.5 * sum(x * H x) + sum(q * x)
  S hx[N];
  for (int i = 0; i < N; ++i) {
    S acc = H[i][0] * x[0];
    for (int j = 1; j < N; ++j) acc = acc + H[i][j] * x[j];
    hx[i] = acc;
  }
  S s1 = x[0] * hx[0], s2 = q[0] * x[0];
  for (int i = 1; i < N; ++i) {
    s1 = s1 + x[i] * hx[i];
    s2 = s2 + q[i] * x[i];
  }
  return S(0.5) * s1 + s2;
}

template <class S, int N>
__device__ inline void free_mask(const S (&H)[N][N], const S* q, const S* x, const S* low,
                                 const S* up, S* g, S* free) {
  for (int i = 0; i < N; ++i) {
    S acc = H[i][0] * x[0];
    for (int j = 1; j < N; ++j) acc = acc + H[i][j] * x[j];
    g[i] = q[i] + acc;
    bool clamped = (x[i] <= low[i] && g[i] >= S(0)) || (x[i] >= up[i] && g[i] <= S(0));
    free[i] = clamped ? S(0) : S(1);
  }
}

// masked projected-Newton box QP (riccati.py::_boxqp_lanes) for one
// scenario on a group: every lane runs the factor and the Newton step (the
// same operations on the same values, so every lane holds the same x), lane
// s < 5 tries step length 2^-s, and the first trial that passes the Armijo
// test wins, as in the plain version's ordered acceptance; its point and
// cost come from the lane that tried it. The masked factor depends on H and
// the free set alone, so it is kept while the free set does not change.
// Returns x, the final free set and its masked factor L.
template <class S, int N, int G>
__device__ inline void boxqp_group(const Group<G>& grp, const S (&H)[N][N], const S* q,
                                   const S* low, const S* up, int iters, S* x, S* free,
                                   S (&L)[N][N]) {
  static_assert(G >= 5, "five Armijo trials a lane each");
  for (int i = 0; i < N; ++i) x[i] = dclip(x[i], low[i], up[i]);
  const double a_lane = 1.0 / (1 << (grp.lane < 5 ? grp.lane : 4));
  S f0 = quad<S, N>(H, q, x);
  S factored[N];  // the free set L belongs to; -1: none yet
  for (int i = 0; i < N; ++i) factored[i] = S(-1);
  S g[N];
  for (int it = 0; it <= iters; ++it) {
    free_mask<S, N>(H, q, x, low, up, g, free);
    bool same = true;
    for (int i = 0; i < N; ++i) same = same && free[i] == factored[i];
    if (!same) {
      masked_factor<S, N>(H, free, L);
      for (int i = 0; i < N; ++i) factored[i] = free[i];
    }
    if (it == iters) break;
    S dx[N], gm[N];
    for (int i = 0; i < N; ++i) gm[i] = g[i] * free[i];
    chol_solve<S, N, true>(L, gm, dx);
    for (int i = 0; i < N; ++i) dx[i] = -dx[i];
    S gdx = g[0] * dx[0];
    for (int i = 1; i < N; ++i) gdx = gdx + g[i] * dx[i];
    S xa[N];
    for (int i = 0; i < N; ++i) xa[i] = dclip(x[i] + S(a_lane) * dx[i], low[i], up[i]);
    const S fa = quad<S, N>(H, q, xa);
    const unsigned passed = grp.ballot(fa - f0 <= S(0.1 * a_lane) * gdx) & 0x1fu;
    const int first = passed ? __ffs(passed) - 1 : 0;  // the same on every lane of the group
    for (int i = 0; i < N; ++i) {
      const S xi = grp.from(first, xa[i]);
      x[i] = passed ? xi : x[i];
    }
    const S f = grp.from(first, fa);
    f0 = passed ? f : f0;
  }
}

}  // namespace aslr
