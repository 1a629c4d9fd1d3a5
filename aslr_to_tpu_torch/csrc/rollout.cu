// K3: two-trial line-search rollout of the VSA soft arm.
//
// Replaces the Pallas kernel aslr_to_tpu/pallas/vsa_kernels.py::
// _rolloutn_kernel with n_trials = 2 (built by build_rolloutn, launched
// from _rollout_call), with its per-knot step _rollout_trial_step and the
// inlined _dynamics_lanes, _running_cost_lanes and _goal_cost_lanes. For
// each trial with its per-scenario step length alpha:
//   u_t = clip(u_ref_t - alpha k_t - K_t (x_t - x_ref_t), lb, ub)
//   x_{t+1} = Euler(x_t, VSA dynamics(x_t, u_t))
// accumulating the running cost, plus wterm * (terminal goal cost).
// Without gaps (BoxDDP): the rollout starts from x0 and contracts nothing.
//
// Thread mapping: one thread per (trial, scenario), 2 B threads; the knot
// loop is serial inside the thread, as the dynamics demand. At B = 4096
// that is 8192 threads, 64 blocks of 128 on 132 SMs: the card is far from
// full and every thread runs a dependent chain of T steps of about 3 RNEA
// sweeps and a log6 each (a few thousand flops per knot). The kernel is
// latency-bound, not bandwidth-bound: per knot and scenario it reads
// 8 + 4 + 4 + 32 values and writes 12 per trial. The Pallas kernel shared
// the loaded inputs between the two trials inside one program; here both
// trials read them, and the second read hits L1/L2. Right first, not fast:
// parallelism inside a scenario (across RNEA columns or trials within a
// warp) is later work.
#include "lanes.cuh"

namespace aslr {

template <class S, int NL>
__global__ void rollout2_kernel(VSAParams<NL> P, const S* __restrict__ xs,
                                const S* __restrict__ us, const S* __restrict__ k,
                                const S* __restrict__ K, const S* __restrict__ x0,
                                const S* __restrict__ alpha_a, const S* __restrict__ alpha_b,
                                const S* __restrict__ wterm, const S* __restrict__ lb,
                                const S* __restrict__ ub, int T, int B,
                                S* __restrict__ xs_a, S* __restrict__ us_a,
                                S* __restrict__ cost_a, S* __restrict__ xs_b,
                                S* __restrict__ us_b, S* __restrict__ cost_b) {
  constexpr int NDX = 4 * NL;
  constexpr int NU = 2 * NL;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 2LL * B) return;
  const int trial = (int)(n / B);
  const int b = (int)(n % B);
  const long long TB = (long long)B;
  const S alpha = trial == 0 ? alpha_a[b] : alpha_b[b];
  S* xs_out = trial == 0 ? xs_a : xs_b;
  S* us_out = trial == 0 ? us_a : us_b;
  S* cost_out = trial == 0 ? cost_a : cost_b;

  S lo[NU], hi[NU];
  for (int j = 0; j < NU; ++j) {
    lo[j] = lb[j * TB + b];
    hi[j] = ub[j * TB + b];
  }
  S x[NDX];
  for (int i = 0; i < NDX; ++i) {
    x[i] = x0[i * TB + b];
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
      u[j] = dclip(us[(kt * NU + j) * TB + b] - fb, lo[j], hi[j]);
      us_out[(kt * NU + j) * TB + b] = u[j];
    }
    S M[NL][NL], tau_c[NL], a[2 * NL], x_new[NDX];
    vsa_dynamics<S, NL>(P, x, u, a, M, tau_c);
    cost = cost + running_cost<S, NL>(P, x, u);
    euler<S, NL>(P.dt, x, a, x_new);
    for (int i = 0; i < NDX; ++i) {
      x[i] = x_new[i];
      xs_out[((kt + 1) * NDX + i) * TB + b] = x[i];
    }
  }
  S r6[6];
  cost_out[b] = cost + wterm[b] * goal_cost<S, NL>(P, x, true, r6);
}

template <class S>
static int launch_rollout2(const double* params, int nl, const S* xs, const S* us,
                           const S* k, const S* K, const S* x0, const S* alpha_a,
                           const S* alpha_b, const S* wterm, const S* lb, const S* ub,
                           int T, int B, S* xs_a, S* us_a, S* cost_a, S* xs_b, S* us_b,
                           S* cost_b, void* stream) {
  if (nl != 2) return -1;
  VSAParams<2> P = unpack_params<2>(params);
  rollout2_kernel<S, 2><<<grid_for(2LL * B), kBlock, 0, (cudaStream_t)stream>>>(
      P, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub, T, B, xs_a, us_a, cost_a, xs_b,
      us_b, cost_b);
  return (int)cudaGetLastError();
}

}  // namespace aslr

#define ASLR_ROLLOUT_ENTRY(NAME, S)                                                      \
  extern "C" int NAME(const double* params, int nl, const S* xs, const S* us, const S* k, \
                      const S* K, const S* x0, const S* alpha_a, const S* alpha_b,       \
                      const S* wterm, const S* lb, const S* ub, int T, int B, S* xs_a,   \
                      S* us_a, S* cost_a, S* xs_b, S* us_b, S* cost_b, void* stream) {   \
    return aslr::launch_rollout2<S>(params, nl, xs, us, k, K, x0, alpha_a, alpha_b,      \
                                    wterm, lb, ub, T, B, xs_a, us_a, cost_a, xs_b, us_b, \
                                    cost_b, stream);                                     \
  }

ASLR_ROLLOUT_ENTRY(aslr_rollout2_f32, float)
ASLR_ROLLOUT_ENTRY(aslr_rollout2_f64, double)
