// Enough of the CUDA runtime to compile a kernel source of
// aslr_to_tpu_torch/csrc with g++ and run it on the CPU, for the tests:
// the execution-space keywords vanish, a launch runs the blocks one after
// another with one std::thread per CUDA thread, and the block and warp
// primitives meet at a std::barrier over the block. That is exact only for
// kernels in which every thread of a block reaches the same barriers,
// votes and shuffles in the same order, as the box kernel's do.
#pragma once

#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

using std::isfinite;

#define __global__
#define __device__
#define __host__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F*, int, int) { return cudaSuccess; }

struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx;
extern dim3_ blockIdx, blockDim;

namespace cpu_cuda {
extern std::barrier<>* block_barrier;
extern std::vector<double> slots;
extern unsigned char* shared_memory;  // the kernel's dynamic shared memory, defined with it
constexpr size_t kSharedBytes = 1 << 20;

inline void sync() { block_barrier->arrive_and_wait(); }

// every thread posts v; returns the slots of its own warp
template <class F>
inline auto exchange(double v, F f) {
  slots[threadIdx.x] = v;
  sync();
  auto r = f(&slots[threadIdx.x & ~31u]);
  sync();
  return r;
}

template <class F, class... A>
void launch(int grid, int block, size_t, cudaStream_t, F* kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    blockDim.x = block;
    std::barrier<> bar(block);
    block_barrier = &bar;
    slots.assign(block, 0.0);
    std::memset(shared_memory, 0xff, kSharedBytes);  // NaN where nothing was staged
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace cpu_cuda

inline void __syncthreads() { cpu_cuda::sync(); }
inline void __syncwarp(unsigned = 0xffffffffu) { cpu_cuda::sync(); }
inline unsigned __ballot_sync(unsigned mask, int p) {
  return cpu_cuda::exchange(p ? 1.0 : 0.0, [mask](const double* w) {
    unsigned r = 0;
    for (int l = 0; l < 32; ++l)
      if ((mask >> l & 1u) && w[l] != 0.0) r |= 1u << l;
    return r;
  });
}
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == mask; }
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width) {
  const unsigned lane = threadIdx.x & 31u;
  return cpu_cuda::exchange((double)v, [=](const double* w) {
    return (T)w[(lane & ~(unsigned)(width - 1)) + src];
  });
}
inline int __ffs(unsigned x) { return __builtin_ffs(x); }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
