// K3: two-trial line-search rollout, and K6: its one-trial instantiation,
// of the soft arm, VSA or SEA.
//
// K3 replaces the Pallas kernel aslr_to_tpu/pallas/vsa_kernels.py::
// _rolloutn_kernel with n_trials = 2 (built by build_rolloutn, launched
// from _rollout_call); K6 replaces _rollout_kernel (vsa_kernels.py:430,
// pallas_call :686 with n_trials = 1, built by build_rollout :739), the
// trial of the per-scenario fast path. Both run the per-knot step
// _rollout_trial_step, the gap-contracted start _rollout_x0t and the
// inlined _dynamics_lanes, _running_cost_lanes and _goal_cost_lanes. For
// each trial with its per-scenario step length alpha:
//   u_t = clip(u_ref_t - alpha k_t - K_t (x_t - x_ref_t), lb, ub)
//   x_{t+1} = Euler(x_t, dynamics(x_t, u_t)) [+ (alpha - 1) infeas fs_{t+1}]
// accumulating the running cost, plus wterm * (terminal goal cost).
// The variants are template parameters: SEA (the actuation), BOXED (the
// clip; compiled out for the unbounded DDP/FDDP families) and GAPS (the
// FDDP gap contraction: x_0 and every step get +(alpha - 1) infeas fs,
// with infeas a per-scenario input that is 0 on a feasible lane).
//
// One trajectory is one thread running rollout_trial; K3 and K6 differ
// only in how many threads a scenario gets (one per trial) and which
// alpha and outputs a thread takes, so K6 at step alpha equals K3's first
// trial at alpha to the bit, as the Pallas kernels did. The knot loop is
// serial inside the thread, as the dynamics demand. At B = 4096, K3 runs
// 8192 threads (64 blocks of 128 on 132 SMs) and K6 4096 (32 blocks):
// the card is far from full and every thread runs a dependent chain of T
// steps of about 3 RNEA sweeps and a log6 each (a few thousand flops per
// knot). The kernels are latency-bound, not bandwidth-bound: per knot and
// scenario a trial reads ndx + 2 nu + nu ndx values (+ ndx of gaps) and
// writes ndx + nu. The Pallas kernel shared the loaded inputs between the
// two trials inside one program; here both trials read them, and the
// second read hits L1/L2. Right first, not fast: parallelism inside a
// scenario (across RNEA columns or trials within a warp) is later work.
#include "lanes.cuh"

namespace aslr {

template <class S, int NL, bool SEA, bool BOXED, bool GAPS>
__device__ __forceinline__ void rollout_trial(
    const VSAParams<NL>& P, const S* __restrict__ xs, const S* __restrict__ us,
    const S* __restrict__ k, const S* __restrict__ K, const S* __restrict__ x0, const S alpha,
    const S* __restrict__ wterm, const S* __restrict__ lb, const S* __restrict__ ub,
    const S* __restrict__ fs, const S* __restrict__ infeas, int T, int B, int b,
    S* __restrict__ xs_out, S* __restrict__ us_out, S* __restrict__ cost_out) {
  constexpr int NDX = Arm<NL, SEA>::NDX;
  constexpr int NU = Arm<NL, SEA>::NU;
  const long long TB = (long long)B;
  S lo[NU], hi[NU];
  if constexpr (BOXED) {
    for (int j = 0; j < NU; ++j) {
      lo[j] = lb[j * TB + b];
      hi[j] = ub[j * TB + b];
    }
  }
  S gscale = S(0);
  if constexpr (GAPS) gscale = (alpha - S(1)) * infeas[b];
  S x[NDX];
  for (int i = 0; i < NDX; ++i) {
    x[i] = x0[i * TB + b];
    if constexpr (GAPS) x[i] = x[i] + fs[i * TB + b] * gscale;
    xs_out[i * TB + b] = x[i];
  }
  S cost = S(0);
  for (int t = 0; t < T; ++t) {
    const long long kt = (long long)t;
    S dx[NDX], u[NU];
    for (int i = 0; i < NDX; ++i) dx[i] = x[i] - xs[(kt * NDX + i) * TB + b];
    for (int j = 0; j < NU; ++j) {
      S fb = k[(kt * NU + j) * TB + b] * alpha;
      for (int i = 0; i < NDX; ++i) fb = fb + K[((kt * NU + j) * NDX + i) * TB + b] * dx[i];
      u[j] = us[(kt * NU + j) * TB + b] - fb;
      if constexpr (BOXED) u[j] = dclip(u[j], lo[j], hi[j]);
      us_out[(kt * NU + j) * TB + b] = u[j];
    }
    S M[NL][NL], tau_c[NL], a[2 * NL], x_new[NDX];
    arm_dynamics<S, NL, SEA>(P, x, u, a, M, tau_c);
    cost = cost + running_cost<S, NL, SEA>(P, x, u);
    euler<S, NL>(P.dt, x, a, x_new);
    for (int i = 0; i < NDX; ++i) {
      x[i] = x_new[i];
      if constexpr (GAPS) x[i] = x[i] + fs[((kt + 1) * NDX + i) * TB + b] * gscale;
      xs_out[((kt + 1) * NDX + i) * TB + b] = x[i];
    }
  }
  S r6[6];
  cost_out[b] = cost + wterm[b] * goal_cost<S, NL>(P, x, true, r6);
}

// K6: one thread per scenario
template <class S, int NL, bool SEA, bool BOXED, bool GAPS>
__global__ void rollout1_kernel(VSAParams<NL> P, const S* __restrict__ xs,
                                const S* __restrict__ us, const S* __restrict__ k,
                                const S* __restrict__ K, const S* __restrict__ x0,
                                const S* __restrict__ alpha, const S* __restrict__ wterm,
                                const S* __restrict__ lb, const S* __restrict__ ub,
                                const S* __restrict__ fs, const S* __restrict__ infeas, int T,
                                int B, S* __restrict__ xs_o, S* __restrict__ us_o,
                                S* __restrict__ cost_o) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= B) return;
  const int b = (int)n;
  rollout_trial<S, NL, SEA, BOXED, GAPS>(P, xs, us, k, K, x0, alpha[b], wterm, lb, ub, fs,
                                         infeas, T, B, b, xs_o, us_o, cost_o);
}

// K3: one thread per (trial, scenario), 2 B threads
template <class S, int NL, bool SEA, bool BOXED, bool GAPS>
__global__ void rollout2_kernel(VSAParams<NL> P, const S* __restrict__ xs,
                                const S* __restrict__ us, const S* __restrict__ k,
                                const S* __restrict__ K, const S* __restrict__ x0,
                                const S* __restrict__ alpha_a, const S* __restrict__ alpha_b,
                                const S* __restrict__ wterm, const S* __restrict__ lb,
                                const S* __restrict__ ub, const S* __restrict__ fs,
                                const S* __restrict__ infeas, int T, int B,
                                S* __restrict__ xs_a, S* __restrict__ us_a,
                                S* __restrict__ cost_a, S* __restrict__ xs_b,
                                S* __restrict__ us_b, S* __restrict__ cost_b) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 2LL * B) return;
  const int trial = (int)(n / B);
  const int b = (int)(n % B);
  const bool first = trial == 0;
  rollout_trial<S, NL, SEA, BOXED, GAPS>(P, xs, us, k, K, x0, first ? alpha_a[b] : alpha_b[b],
                                         wterm, lb, ub, fs, infeas, T, B, b,
                                         first ? xs_a : xs_b, first ? us_a : us_b,
                                         first ? cost_a : cost_b);
}

template <class S, bool SEA, bool BOXED, bool GAPS>
static void launch_variant(int ntrials, const VSAParams<2>& P, const S* xs, const S* us,
                           const S* k, const S* K, const S* x0, const S* alpha_a,
                           const S* alpha_b, const S* wterm, const S* lb, const S* ub,
                           const S* fs, const S* infeas, int T, int B, S* xs_a, S* us_a,
                           S* cost_a, S* xs_b, S* us_b, S* cost_b, void* stream) {
  if (ntrials == 1)
    rollout1_kernel<S, 2, SEA, BOXED, GAPS><<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
        P, xs, us, k, K, x0, alpha_a, wterm, lb, ub, fs, infeas, T, B, xs_a, us_a, cost_a);
  else
    rollout2_kernel<S, 2, SEA, BOXED, GAPS><<<grid_for(2LL * B), kBlock, 0,
                                              (cudaStream_t)stream>>>(
        P, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub, fs, infeas, T, B, xs_a, us_a,
        cost_a, xs_b, us_b, cost_b);
}

// ntrials 1 (K6: alpha_b and the b outputs unused) or 2 (K3); lb/ub null:
// no box; fs/infeas null: no gaps
template <class S>
static int launch_rollout(int ntrials, const double* params, int nl, const S* xs, const S* us,
                          const S* k, const S* K, const S* x0, const S* alpha_a,
                          const S* alpha_b, const S* wterm, const S* lb, const S* ub,
                          const S* fs, const S* infeas, int T, int B, S* xs_a, S* us_a,
                          S* cost_a, S* xs_b, S* us_b, S* cost_b, void* stream) {
  if (nl != 2) return -1;
  VSAParams<2> P = unpack_params<2>(params);
  const int variant = (P.sea ? 4 : 0) + (lb ? 2 : 0) + (fs ? 1 : 0);
#define ASLR_ROLLOUT_CASE(V, SEA, BOXED, GAPS)                                             \
  case V:                                                                                 \
    launch_variant<S, SEA, BOXED, GAPS>(ntrials, P, xs, us, k, K, x0, alpha_a, alpha_b,   \
                                        wterm, lb, ub, fs, infeas, T, B, xs_a, us_a,      \
                                        cost_a, xs_b, us_b, cost_b, stream);              \
    break;
  switch (variant) {
    ASLR_ROLLOUT_CASE(0, false, false, false)
    ASLR_ROLLOUT_CASE(1, false, false, true)
    ASLR_ROLLOUT_CASE(2, false, true, false)
    ASLR_ROLLOUT_CASE(3, false, true, true)
    ASLR_ROLLOUT_CASE(4, true, false, false)
    ASLR_ROLLOUT_CASE(5, true, false, true)
    ASLR_ROLLOUT_CASE(6, true, true, false)
    ASLR_ROLLOUT_CASE(7, true, true, true)
  }
#undef ASLR_ROLLOUT_CASE
  return (int)cudaGetLastError();
}

}  // namespace aslr

#define ASLR_ROLLOUT2_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha_a, const S* alpha_b,         \
                      const S* wterm, const S* lb, const S* ub, const S* fs,               \
                      const S* infeas, int T, int B, S* xs_a, S* us_a, S* cost_a, S* xs_b, \
                      S* us_b, S* cost_b, void* stream) {                                  \
    return aslr::launch_rollout<S>(2, params, nl, xs, us, k, K, x0, alpha_a, alpha_b,      \
                                   wterm, lb, ub, fs, infeas, T, B, xs_a, us_a, cost_a,    \
                                   xs_b, us_b, cost_b, stream);                            \
  }

#define ASLR_ROLLOUT1_ENTRY(NAME, S)                                                       \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k,   \
                      const S* K, const S* x0, const S* alpha, const S* wterm,             \
                      const S* lb, const S* ub, const S* fs, const S* infeas, int T, int B, \
                      S* xs_o, S* us_o, S* cost_o, void* stream) {                         \
    return aslr::launch_rollout<S>(1, params, nl, xs, us, k, K, x0, alpha, nullptr, wterm, \
                                   lb, ub, fs, infeas, T, B, xs_o, us_o, cost_o, nullptr,  \
                                   nullptr, nullptr, stream);                              \
  }

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f32, float)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f64, double)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f32, float)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f64, double)
