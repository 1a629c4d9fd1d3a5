// Shared device-side pieces of the port's kernels: forward-mode dual
// numbers, NaN-propagating helpers that follow JAX's semantics, the
// parameter block that carries a workload's constants, and lane indexing.
//
// Layout at every kernel boundary: batch innermost and contiguous, so the
// element (i0, ..., ik) of scenario b of a tensor [d0, ..., dk, B] sits at
// ((i0 * d1 + i1) * ... + ik) * B + b. One thread handles one scenario
// (or one scenario and knot); neighbouring threads touch neighbouring
// addresses, so every load and store coalesces.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace aslr {

// ---------------------------------------------------------------------------
// forward-mode dual numbers: value v and tangent d (the kernel's stand-in for
// jax.jvp). Operations follow JAX's jvp rules, including the tie rule of
// max/min (half the tangent to each side).
// ---------------------------------------------------------------------------

template <class S>
struct Dual {
  S v, d;
  __device__ Dual() {}
  __device__ Dual(S value) : v(value), d(S(0)) {}
  __device__ Dual(S value, S tangent) : v(value), d(tangent) {}
};

template <class S> __device__ inline Dual<S> operator+(Dual<S> a, Dual<S> b) { return {a.v + b.v, a.d + b.d}; }
template <class S> __device__ inline Dual<S> operator-(Dual<S> a, Dual<S> b) { return {a.v - b.v, a.d - b.d}; }
template <class S> __device__ inline Dual<S> operator-(Dual<S> a) { return {-a.v, -a.d}; }
template <class S> __device__ inline Dual<S> operator*(Dual<S> a, Dual<S> b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
template <class S> __device__ inline Dual<S> operator/(Dual<S> a, Dual<S> b) {
  return {a.v / b.v, a.d / b.v - b.d * a.v / (b.v * b.v)};
}
template <class S> __device__ inline Dual<S> operator+(Dual<S> a, S b) { return {a.v + b, a.d}; }
template <class S> __device__ inline Dual<S> operator+(S a, Dual<S> b) { return {a + b.v, b.d}; }
template <class S> __device__ inline Dual<S> operator-(Dual<S> a, S b) { return {a.v - b, a.d}; }
template <class S> __device__ inline Dual<S> operator-(S a, Dual<S> b) { return {a - b.v, -b.d}; }
template <class S> __device__ inline Dual<S> operator*(Dual<S> a, S b) { return {a.v * b, a.d * b}; }
template <class S> __device__ inline Dual<S> operator*(S a, Dual<S> b) { return {a * b.v, a * b.d}; }
template <class S> __device__ inline Dual<S> operator/(Dual<S> a, S b) { return {a.v / b, a.d / b}; }
template <class S> __device__ inline Dual<S> operator/(S a, Dual<S> b) { return {a / b.v, -b.d * a / (b.v * b.v)}; }

// value of a scalar or a dual (for comparisons, which see values only)
__device__ inline float val(float x) { return x; }
__device__ inline double val(double x) { return x; }
template <class S> __device__ inline S val(Dual<S> x) { return x.v; }

// scalar type underneath V
template <class V> struct scalar_of { typedef V type; };
template <class S> struct scalar_of<Dual<S>> { typedef S type; };

__device__ inline float dsqrt(float x) { return sqrtf(x); }
__device__ inline double dsqrt(double x) { return sqrt(x); }
template <class S> __device__ inline Dual<S> dsqrt(Dual<S> x) {
  S r = dsqrt(x.v);
  return {r, x.d * (S(0.5) / r)};
}
__device__ inline float dsin(float x) { return sinf(x); }
__device__ inline double dsin(double x) { return sin(x); }
__device__ inline float dcos(float x) { return cosf(x); }
__device__ inline double dcos(double x) { return cos(x); }
template <class S> __device__ inline Dual<S> dsin(Dual<S> x) { return {dsin(x.v), x.d * dcos(x.v)}; }
template <class S> __device__ inline Dual<S> dcos(Dual<S> x) { return {dcos(x.v), x.d * -dsin(x.v)}; }
__device__ inline float datan2(float y, float x) { return atan2f(y, x); }
__device__ inline double datan2(double y, double x) { return atan2(y, x); }
template <class S> __device__ inline Dual<S> datan2(Dual<S> y, Dual<S> x) {
  S den = x.v * x.v + y.v * y.v;
  return {datan2(y.v, x.v), y.d * (x.v / den) + x.d * (-y.v / den)};
}
__device__ inline float dabs(float x) { return fabsf(x); }
__device__ inline double dabs(double x) { return fabs(x); }
template <class S> __device__ inline Dual<S> dabs(Dual<S> x) {
  S sg = x.v > S(0) ? S(1) : (x.v < S(0) ? S(-1) : S(0));
  return {dabs(x.v), x.d * sg};
}

// NaN-propagating max/min (jnp.maximum / jnp.minimum): fmax would drop a NaN
template <class S> __device__ inline S dmax(S a, S b) { return (a != a) ? a : ((b != b) ? b : (a > b ? a : b)); }
template <class S> __device__ inline S dmin(S a, S b) { return (a != a) ? a : ((b != b) ? b : (a < b ? a : b)); }
// dual max/min: the tangent weights follow JAX (1/0, or 1/2 each at a tie)
template <class S> __device__ inline Dual<S> dmax(Dual<S> a, Dual<S> b) {
  S v = dmax(a.v, b.v);
  S wa = (a.v == v) ? ((b.v == v) ? S(0.5) : S(1)) : S(0);
  S wb = (b.v == v) ? ((a.v == v) ? S(0.5) : S(1)) : S(0);
  return {v, a.d * wa + b.d * wb};
}
template <class S> __device__ inline Dual<S> dmin(Dual<S> a, Dual<S> b) {
  S v = dmin(a.v, b.v);
  S wa = (a.v == v) ? ((b.v == v) ? S(0.5) : S(1)) : S(0);
  S wb = (b.v == v) ? ((a.v == v) ? S(0.5) : S(1)) : S(0);
  return {v, a.d * wa + b.d * wb};
}
// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi)
template <class V> __device__ inline V dclip(V x, V lo, V hi) { return dmin(dmax(x, lo), hi); }

template <class V> __device__ inline V sel(bool c, V a, V b) { return c ? a : b; }

template <class S> __device__ inline bool finite(S x) { return isfinite(x); }

// ---------------------------------------------------------------------------
// the workload's constants, passed to every kernel by value (one build
// serves every preset). Unpacked from a flat float64 array in the order of
// aslr_to_tpu_torch/kernels/vsa_kernels.py::pack_params. The actuation
// variant rides in the block as a flag that the host-side launchers read to
// pick the kernel's instantiation; inside a kernel it is the template
// parameter SEA, never a per-thread branch.
// ---------------------------------------------------------------------------

// dimensions of an NL-link soft arm: state tangent 4 NL; controls 2 NL for
// the VSA (u = [tau_m, k]) and NL for the SEA (u = tau_m)
template <int NL, bool SEA>
struct Arm {
  static constexpr int NDX = 4 * NL;
  static constexpr int NU = SEA ? NL : 2 * NL;
};

template <int NL>
struct VSAParams {
  double dt;
  double binv[NL][NL];
  double joint_rot[NL][3][3];
  double joint_pos[NL][3];
  double axis[NL][3];
  double mass[NL];
  double com[NL][3];
  double inertia[NL][3][3];
  double gravity[3];
  int frame_parent;
  double frame_rot[3][3];
  double frame_pos[3];
  double tgt_rinv[3][3];   // running goal: target rotation, inverted
  double tgt_pos[3];
  double term_rinv[3][3];  // terminal goal target
  double term_pos[3];
  double w_goal;
  double xw[4 * NL];       // combined state-reg weights
  double uw[2 * NL];       // combined control-reg weights (first nu used)
  double stiff_w;
  double stiff_ref[NL];
  int sea;                 // 1: SEA (constant spring K), 0: VSA (K = diag(k))
  double K[NL][NL];        // SEA spring matrix (zeros for the VSA)
};

struct Reader {
  const double* p;
  __host__ double next() { return *p++; }
  __host__ void fill(double* dst, int n) { for (int i = 0; i < n; ++i) dst[i] = *p++; }
};

template <int NL>
__host__ VSAParams<NL> unpack_params(const double* flat) {
  VSAParams<NL> P;
  Reader r{flat};
  P.dt = r.next();
  r.fill(&P.binv[0][0], NL * NL);
  r.fill(&P.joint_rot[0][0][0], NL * 9);
  r.fill(&P.joint_pos[0][0], NL * 3);
  r.fill(&P.axis[0][0], NL * 3);
  r.fill(P.mass, NL);
  r.fill(&P.com[0][0], NL * 3);
  r.fill(&P.inertia[0][0][0], NL * 9);
  r.fill(P.gravity, 3);
  P.frame_parent = (int)r.next();
  r.fill(&P.frame_rot[0][0], 9);
  r.fill(P.frame_pos, 3);
  r.fill(&P.tgt_rinv[0][0], 9);
  r.fill(P.tgt_pos, 3);
  r.fill(&P.term_rinv[0][0], 9);
  r.fill(P.term_pos, 3);
  P.w_goal = r.next();
  r.fill(P.xw, 4 * NL);
  r.fill(P.uw, 2 * NL);
  P.stiff_w = r.next();
  r.fill(P.stiff_ref, NL);
  P.sea = (int)r.next();
  r.fill(&P.K[0][0], NL * NL);
  return P;
}

constexpr int kBlock = 128;
// a launcher's answer for a shape or variant it has no instance of
constexpr int kNoInstance = -1;

// how an instance takes a per-knot problem's tables: never (the shared
// problem's code, with no table branch compiled in), always, or by a
// uniform branch on a null pointer. A branch compiled into the shared
// path's instance cost it time and registers where the code is tight (K1
// and the rollouts at nl = 2, the rollouts at nl = 7; PERF.md, PR 9), so
// there the tables have instances of their own.
enum TableMode { kShared = 0, kTables = 1, kEither = 2 };
// the dynamic shared memory a block may have on an H100 (232,448 bytes)
constexpr size_t kMaxSmem = 227 * 1024;

// the least power of two at or above n
constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

inline int grid_for(long long n) { return (int)((n + kBlock - 1) / kBlock); }

// a pointer that a 16-byte cp.async may take (null: an input not passed)
inline bool aligned16(const void* p) { return p == nullptr || ((size_t)p & 15) == 0; }

// G consecutive lanes of a warp (G a power of two) that hold one scenario:
// they meet and vote on their own mask, never on the whole warp's
template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a power of two within a warp");
  int lane;
  unsigned base, mask;
  __device__ Group() {
    const unsigned l = threadIdx.x & 31u;
    lane = (int)(l & (G - 1));
    base = l & ~(unsigned)(G - 1);
    mask = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << base;
  }
  __device__ void sync() const { __syncwarp(mask); }
  __device__ bool all(bool p) const { return __all_sync(mask, p) != 0; }
  __device__ unsigned ballot(bool p) const { return __ballot_sync(mask, p) >> base; }
  template <class S>
  __device__ S from(int lane_of_group, S v) const { return __shfl_sync(mask, v, lane_of_group, G); }
};

}  // namespace aslr
