// P: dependent multiply-add chains per thread, a latency and throughput
// probe of the card's float32 pipeline.
//
// Replaces the Pallas kernel scripts/probe_sublane.py::kern (:40, pallas_call
// :61), which measured whether [8, 128] values run at the cost of [128]
// ones in the TPU's vector registers. Per element it computes the same
// recurrence: ilp interleaved chains x_k <- x_k * 0.9999 + x0, CHAIN / ilp
// steps each, repeated LOOP times, from x_k = x0 * 1e-6 (k + 1), and writes
// the sum of the chains. What the H100 offers in place of the sublane
// packing are independent chains per thread (ILP) and threads in flight
// (the batch): ilp = 1 is one dependent chain, bound by the latency of a
// multiply-add; more chains fill the pipeline until the card is bound by
// operations. MODE picks the arithmetic: a separate multiply and add
// (__fmul_rn, __fadd_rn: two roundings, what -fmad=false gives every other
// kernel of the port) or fmaf (one rounding, contracted whatever the
// flag). The plain version (aslr_to_tpu_torch/probe.py) is the mul+add
// recurrence in PyTorch; it equals the first mode to the bit.
#include <cuda_runtime.h>

namespace aslr {

template <int ILP, bool FMA>
__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                             int steps, int loop) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  const float c = 0.9999f;
  float xs[ILP];
#pragma unroll
  for (int k = 0; k < ILP; ++k) xs[k] = x0 * (float)(1e-6 * (k + 1));
  for (int l = 0; l < loop; ++l) {
#pragma unroll 5
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < ILP; ++k)
        xs[k] = FMA ? fmaf(xs[k], c, x0) : __fadd_rn(__fmul_rn(xs[k], c), x0);
    }
  }
  float acc = xs[0];
#pragma unroll
  for (int k = 1; k < ILP; ++k) acc = acc + xs[k];
  out[i] = acc;
}

template <int ILP>
static void launch(bool fma, const float* x, float* out, int n, int steps, int loop,
                   cudaStream_t stream) {
  const int block = 128;
  const int grid = (int)(((long long)n + block - 1) / block);
  if (fma)
    probe_kernel<ILP, true><<<grid, block, 0, stream>>>(x, out, n, steps, loop);
  else
    probe_kernel<ILP, false><<<grid, block, 0, stream>>>(x, out, n, steps, loop);
}

}  // namespace aslr

// steps = CHAIN / ilp; returns -1 for an ilp without an instantiation
extern "C" int aslr_probe_f32(const float* x, float* out, int n, int ilp, int fma, int steps,
                              int loop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (ilp) {
    case 1: aslr::launch<1>(fma != 0, x, out, n, steps, loop, s); break;
    case 2: aslr::launch<2>(fma != 0, x, out, n, steps, loop, s); break;
    case 4: aslr::launch<4>(fma != 0, x, out, n, steps, loop, s); break;
    case 8: aslr::launch<8>(fma != 0, x, out, n, steps, loop, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
