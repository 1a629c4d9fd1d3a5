// The state behind cuda_runtime.h's CPU stand-ins.
#include "cuda_runtime.h"

thread_local dim3_ threadIdx;
int cpu_cuda_sm_count = 132;
dim3_ blockIdx, blockDim;

namespace cpu_cuda {
std::barrier<>* block_barrier;
std::vector<std::barrier<>*> warp_barriers;
std::vector<double> slots;
}  // namespace cpu_cuda
