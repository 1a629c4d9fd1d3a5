// Enough of the CUDA runtime to compile a kernel source of
// aslr_to_tpu_torch/csrc with g++ and run it on the CPU, for the tests:
// the execution-space keywords vanish, a launch runs the blocks one after
// another, each CUDA thread of a block as a fiber (a stack of its own,
// switched to by hand on one OS thread, runtime.cpp), __syncthreads meets at
// a barrier over the block and the warp primitives (__syncwarp, votes,
// shuffles) at one over the warp. A fiber runs until it waits at a barrier;
// the scheduler then runs the next one, sweeping the block's threads in
// increasing and decreasing order by turns, so a read of shared memory that
// a missing barrier leaves racing sees the other thread's write before it
// in one phase or the next. That is exact only for kernels in which every
// thread of a block reaches the same __syncthreads, and every thread of a
// warp the same warp primitives, in the same order, as the box kernel's and
// the rollout's do (a warp may branch where the others do not, as long as
// all its lanes branch alike).
#pragma once

#include <cmath>
#include <cstring>
#include <functional>
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// the card's SMs as a launcher reads them: an H100's 132, which a test may
// set (cpu_cuda_sm_count) to steer a launch that picks its layout by them
extern "C" int cpu_cuda_sm_count;
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = cpu_cuda_sm_count;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F*, int, int) { return cudaSuccess; }
// the CPU runs one block at a time
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx;  // the running fiber's, set by the scheduler
extern dim3_ blockIdx, blockDim;

namespace cpu_cuda {
struct Barrier {
  int expected, count;
  unsigned phase;
};
extern Barrier block_barrier;
extern std::vector<Barrier> warp_barriers;
extern std::vector<double> slots;
extern unsigned char* shared_memory;  // the kernel's dynamic shared memory, defined with it
constexpr size_t kSharedBytes = 1 << 20;

void yield();  // back to the scheduler, which runs the next fiber
// runs body once for each thread of a block of `block`, as fibers
void run_block(int block, const std::function<void()>& body);

inline void arrive_and_wait(Barrier& b) {
  const unsigned phase = b.phase;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.phase;
    return;
  }
  while (b.phase == phase) yield();
}
inline void sync() { arrive_and_wait(block_barrier); }
inline void warp_sync() { arrive_and_wait(warp_barriers[threadIdx.x / 32]); }

// every thread posts v; returns the slots of its own warp
template <class F>
inline auto exchange(double v, F f) {
  slots[threadIdx.x] = v;
  warp_sync();
  auto r = f(&slots[threadIdx.x & ~31u]);
  warp_sync();
  return r;
}

template <class F, class... A>
void launch(int grid, int block, size_t, cudaStream_t, F* kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    blockDim.x = block;
    block_barrier = Barrier{block, 0, 0};
    warp_barriers.clear();
    for (int w = 0; w * 32 < block; ++w)
      warp_barriers.push_back(Barrier{block - w * 32 < 32 ? block - w * 32 : 32, 0, 0});
    slots.assign(block, 0.0);
    std::memset(shared_memory, 0xff, kSharedBytes);  // NaN where nothing was staged
    run_block(block, [&] { kernel(args...); });
  }
}
}  // namespace cpu_cuda

inline void __syncthreads() { cpu_cuda::sync(); }
inline void __syncwarp(unsigned = 0xffffffffu) { cpu_cuda::warp_sync(); }
inline unsigned __ballot_sync(unsigned mask, int p) {
  return cpu_cuda::exchange(p ? 1.0 : 0.0, [mask](const double* w) {
    unsigned r = 0;
    for (int l = 0; l < 32; ++l)
      if ((mask >> l & 1u) && w[l] != 0.0) r |= 1u << l;
    return r;
  });
}
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == mask; }
// a shuffle whose mask leaves out the calling lane or its source lane is
// undefined on the card; here it reads NaN, so the fault shows in the output
template <class T>
inline T __shfl_sync(unsigned mask, T v, int src, int width) {
  const unsigned lane = threadIdx.x & 31u, from = (lane & ~(unsigned)(width - 1)) + src;
  return cpu_cuda::exchange((double)v, [=](const double* w) {
    return (mask >> lane & 1u) && (mask >> from & 1u) ? (T)w[from] : (T)NAN;
  });
}
inline int __ffs(unsigned x) { return __builtin_ffs(x); }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
