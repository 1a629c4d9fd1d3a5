// Small dense linear algebra, per thread, shared by the backward Riccati
// kernels (K2, K4 and K5, one group kernel in riccati_box.cu), and the
// masked projected-Newton BoxQP of K2/K5 over a group of lanes that holds
// one scenario: whole on every lane of the group (boxqp_group), or, in K5's
// wide layout where a scenario has a warp, spread over it (boxqp_rows).
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

// ---------------------------------------------------------------------------
// The BoxQP of K5's wide layout (riccati_box.cu::fddp_sweep_wide), a warp a
// scenario: boxqp_group's iterates, bit for bit, with the arithmetic spread
// over the warp. boxqp_group has every lane run the whole QP: that costs no
// issue slots, but leaves each knot one long chain of dependent
// instructions (the row sums of H x for three free masks, two trials and
// the start's cost at qp_iters 2, 49 products each; the masked factor's
// triangle). Here lane l owns row i of the QP and trial group g (qp_row:
// l mod N in the warp's 32 / N whole groups of N lanes; the lanes past them
// repeat rows 0.. of group 0):
//   - row i of H sits in the lane's registers, read once from the exchange;
//     H x is one row sum a lane, kept from the cost of the accepted point
//     for the next free mask, and the free set is a ballot of the rows;
//   - the masked factor runs a column a pass: lane k's pivot shuffled to
//     every lane, its square root, lane i's L[i][k] by one division,
//     column k shuffled to every lane, lane i's row updated, each entry
//     taking chol's subtractions in chol's order; the factor goes to
//     shared memory;
//   - the triangular solves stay whole on every lane: a solve is a chain of
//     divisions, each waiting on the last, and a split would add a shuffle
//     to each link. The gains' solve (each lane its own right-hand side)
//     runs the Newton steps' code once more after the last step;
//   - the trials: group g tries step length 2^-g (four at N = 7, on lanes
//     0-27), the fifth only where none of those passed (a second pass,
//     kQpTrialsAPass); each trial's row sums once, on its group's lanes, and
//     its cost folded on every lane of the group in quad's order; the first
//     group that passes, by a ballot of the groups' first lanes, gives the
//     point, its row sums and its cost.
// A knot runs the factor, the first step and the gains once: code that no
// loop keeps warm. Its cost on the card fell with the code's size (one
// copy of the factor's column and of the solve; box_variants.py --shape
// 28x7 times the unrolled forms). Every sum runs in the order of
// boxqp_group's (and the plain version's).
// ---------------------------------------------------------------------------

constexpr unsigned kFullWarp = 0xffffffffu;
// Armijo trials a pass of boxqp_rows (at most the groups a warp holds; the
// rest of the five follow, a pass at a time, only where none passed)
constexpr int kQpTrialsAPass = 4;

template <class S>
__device__ inline S wshfl(S v, int src) { return __shfl_sync(kFullWarp, v, src, 32); }

// v[i] for a run-time i < N, by selects (an array indexed at run time would
// go to local memory)
template <int N, class S>
__device__ inline S lane_pick(const S (&v)[N], int i) {
  S r = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = i == j ? v[j] : r;
  return r;
}

// this lane's row of an N-row QP spread over the warp, and its trial group
template <int N>
__device__ inline int qp_row(int* group = nullptr) {
  constexpr int TG = 32 / N;
  const int l = (int)(threadIdx.x & 31u), m = l < TG * N ? l : l - TG * N;
  if (group) *group = m / N;
  return m % N;
}

template <class S>
__device__ inline S flag(unsigned bits, int j) { return (bits >> j & 1u) ? S(1) : S(0); }

// div0<true>(a, b, b_regular)'s quotient without its branch: the division
// runs on every lane, with a dividend of 1 where a zero over a regular
// divisor takes a * b, so that no zero dividend goes down its slow path.
// The triangular solves take it: their zeros are the clamped controls',
// which differ from one warp to the next, and a knot waits on the slowest
// warp of its block; the factor, whose zeros differ from lane to lane, keeps
// div0's branch (box_variants.py --shape 28x7 --iterate times each form in
// each place, on a solve's iterate too)
template <class S>
__device__ inline S div0_sel(S a, S b, bool b_regular) {
  const bool skip = a == S(0) && b_regular;
  const S q = (skip ? S(1) : a) / b;
  return skip ? a * b : q;
}

// chol_solve<S, N, true> with div0_sel's quotients (the same bits)
template <class S, int N>
__device__ inline void solve_rows(const S (&L)[N][N], const S* b, S* x) {
  bool reg[N];
#pragma unroll
  for (int i = 0; i < N; ++i) reg[i] = regular(L[i][i]);
  S y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = div0_sel(s, L[i][i], reg[i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    S s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = div0_sel(s, L[i][i], reg[i]);
  }
}

// 0.5 x.Hx + q.x (quad) on every lane of the group whose first lane is base;
// h: row i of H, x: the whole point on every lane; hx: row i of H x
template <class S, int N>
__device__ inline S quad_rows(const S (&h)[N], const S (&q)[N], const S (&x)[N], int base,
                              S& hx) {
  S acc = h[0] * x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc + h[j] * x[j];
  hx = acc;
  S s1 = S(0), s2 = S(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const S hj = wshfl(acc, base + j);
    s1 = j == 0 ? x[0] * hj : s1 + x[j] * hj;
    s2 = j == 0 ? q[0] * x[0] : s2 + q[j] * x[j];
  }
  return S(0.5) * s1 + s2;
}

// the masked factor (masked_factor, chol<S, N, true>) of H on the free set
// fm (bit j: control j free), row i computed on this lane (l its lane), into
// Lsm (row-major [N, N], the lower triangle) in shared memory: a column a
// pass of one copy of the code, the lane's row shifted so that column k
// sits in a[0]
template <class S, int N>
__device__ inline void factor_rows(const S (&h)[N], unsigned fm, int i, int l, S* Lsm) {
  const S fi = flag<S>(fm, i);
  S a[N];  // row i of the masked system, from column k on
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = h[j] * (fi * flag<S>(fm, j));
    if (j == i) a[j] = a[j] + (S(1) - fi);
  }
  S piv = a[0];  // lane k's: its diagonal entry, less the columns before k
  __syncwarp();  // every lane done with the factor before
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const S d = dsqrt(wshfl(piv, k));
    // L[i][k] on lane i > k; the other lanes divide a zero, which skips
    // (div0's branch: here the zeros fall on some lanes and not others)
    const S lik = div0<true>(i > k ? a[0] : S(0), d, regular(d));
    if (l < N && i >= k) Lsm[i * N + k] = i == k ? d : lik;
    // lane k + 1's next pivot first, from its own L[k + 1][k]: the same
    // subtraction as its row's below, off the shuffles' chain
    piv = a[1] - lik * lik;
#pragma unroll
    for (int j = 1; j < N; ++j) a[j - 1] = a[j] - lik * wshfl(lik, k + j);
  }
  __syncwarp();
}

// masked projected-Newton box QP (boxqp_group's iterates) on a warp, and the
// free-subspace gains of its final free set: H the [N, N] Hessian in shared
// memory, q the gradient on every lane; lo, hi and x0 this lane's row's box
// and start (qp_row); kr the lane's right-hand side of the gains (a row of
// Qxu); Lsm [N, N] of shared memory for the factor. Returns the point x on
// every lane and the lane's gains kc (the masked solve of kr). The Newton
// steps and the gains share one copy of the solve.
template <class S, int N>
__device__ inline void boxqp_rows(const S* H, const S (&q)[N], S lo, S hi, S x0, int iters,
                                  const S (&kr)[N], S* Lsm, S (&x)[N], S (&kc)[N]) {
  constexpr int TPP = kQpTrialsAPass, NTRIAL = 5, PASSES = (NTRIAL + TPP - 1) / TPP;
  static_assert(TPP >= 1 && TPP * N <= 32, "a group of N lanes a trial");
  int g;
  const int i = qp_row<N>(&g), base = g * N, l = (int)(threadIdx.x & 31u);
  const S(&Lf)[N][N] = *reinterpret_cast<const S(*)[N][N]>(Lsm);
  S h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) h[j] = H[i * N + j];
  const S qi = lane_pick(q, i);
  S xi = dclip(x0, lo, hi);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = wshfl(xi, j);
  S hx;  // row i of H x
  S f0 = quad_rows<S, N>(h, q, x, base, hx);
  unsigned factored = ~0u;  // the free set Lsm belongs to; none yet
  for (int it = 0;; ++it) {
    const S gi = qi + hx;
    const bool clamped = (xi <= lo && gi >= S(0)) || (xi >= hi && gi <= S(0));
    const unsigned fm = __ballot_sync(kFullWarp, !clamped) & ((1u << N) - 1u);
    if (fm != factored) {
      factor_rows<S, N>(h, fm, i, l, Lsm);
      factored = fm;
    }
    // the Newton step's system, or after the last step the gains'
    const bool last = it == iters;
    S gv[N], rhs[N], sol[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      gv[j] = wshfl(gi, j);
      rhs[j] = (last ? kr[j] : gv[j]) * flag<S>(fm, j);
    }
    solve_rows<S, N>(Lf, rhs, sol);
    if (last) {
#pragma unroll
      for (int j = 0; j < N; ++j) kc[j] = sol[j];
      break;
    }
    S dx[N];
#pragma unroll
    for (int j = 0; j < N; ++j) dx[j] = -sol[j];
    S gdx = gv[0] * dx[0];
#pragma unroll
    for (int j = 1; j < N; ++j) gdx = gdx + gv[j] * dx[j];
    const S dxi = lane_pick(dx, i);
#pragma unroll 1
    for (int p = 0; p < PASSES; ++p) {
      const int s = p * TPP + g;  // this group's trial
      const bool tries = g < TPP && s < NTRIAL;
      const double a = 1.0 / (1 << (tries ? s : 0));
      const S xai = dclip(xi + S(a) * dxi, lo, hi);
      S xa[N];
#pragma unroll
      for (int j = 0; j < N; ++j) xa[j] = wshfl(xai, base + j);
      S hxa;
      const S fa = quad_rows<S, N>(h, q, xa, base, hxa);
      const unsigned passed =
          __ballot_sync(kFullWarp, tries && l == base && fa - f0 <= S(0.1 * a) * gdx);
      if (passed) {  // the first trial that passed: its group's first lane
        const int w = __ffs(passed) - 1;
#pragma unroll
        for (int j = 0; j < N; ++j) x[j] = wshfl(xa[j], w);
        xi = wshfl(xai, w + i);
        hx = wshfl(hxa, w + i);
        f0 = wshfl(fa, w);
        break;
      }
    }
  }
}

}  // namespace aslr
