// Small dense linear algebra and the masked projected-Newton BoxQP, per
// thread (one scenario), shared by the backward Riccati kernels: K2
// (riccati_box.cu) and K4/K5 (riccati_fddp.cu).
//
// Replaces the helpers of aslr_to_tpu/pallas/riccati.py: _chol4,
// _chol4_solve, _masked_chol_solve and _boxqp_lanes. Every sum runs in the
// order of its plain twin in aslr_to_tpu_torch/kernels/riccati.py.
#pragma once

#include "common.cuh"

namespace aslr {

template <class S, int N>
__device__ inline void chol(const S (&A)[N][N], S (&L)[N][N]) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j) {
      S s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? dsqrt(s) : s / L[j][j];
    }
}

template <class S, int N>
__device__ inline void chol_solve(const S (&L)[N][N], const S* b, S* x) {
  S y[N];
  for (int i = 0; i < N; ++i) {
    S s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = N - 1; i >= 0; --i) {
    S s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// masked system: clamped rows/columns replaced by identity (riccati.py::
// _masked_chol_solve); factor once
template <class S, int N>
__device__ inline void masked_factor(const S (&Quu)[N][N], const S* free, S (&L)[N][N]) {
  S A[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      A[i][j] = Quu[i][j] * (free[i] * free[j]);
      if (i == j) A[i][j] = A[i][j] + (S(1) - free[i]);
    }
  chol<S, N>(A, L);
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

// masked projected-Newton box QP (riccati.py::_boxqp_lanes)
template <class S, int N>
__device__ inline void boxqp(const S (&H)[N][N], const S* q, const S* low, const S* up,
                             int iters, S* x, S* free) {
  for (int i = 0; i < N; ++i) x[i] = dclip(x[i], low[i], up[i]);
  for (int it = 0; it < iters; ++it) {
    S g[N], dx[N], gm[N], L[N][N];
    free_mask<S, N>(H, q, x, low, up, g, free);
    masked_factor<S, N>(H, free, L);
    for (int i = 0; i < N; ++i) gm[i] = g[i] * free[i];
    chol_solve<S, N>(L, gm, dx);
    for (int i = 0; i < N; ++i) dx[i] = -dx[i];
    const S f0 = quad<S, N>(H, q, x);
    S gdx = g[0] * dx[0];
    for (int i = 1; i < N; ++i) gdx = gdx + g[i] * dx[i];
    S best[N];
    for (int i = 0; i < N; ++i) best[i] = x[i];
    bool accepted = false;
    double a = 1.0;
    for (int s = 0; s < 5; ++s, a *= 0.5) {
      S xa[N];
      for (int i = 0; i < N; ++i) xa[i] = dclip(x[i] + S(a) * dx[i], low[i], up[i]);
      const S fa = quad<S, N>(H, q, xa);
      const bool ok_a = (fa - f0 <= S(0.1 * a) * gdx) && !accepted;
      if (ok_a)
        for (int i = 0; i < N; ++i) best[i] = xa[i];
      accepted = accepted || ok_a;
    }
    for (int i = 0; i < N; ++i) x[i] = best[i];
  }
  S g[N];
  free_mask<S, N>(H, q, x, low, up, g, free);
}

}  // namespace aslr
