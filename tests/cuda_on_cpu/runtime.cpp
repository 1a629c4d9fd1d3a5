// The state behind cuda_runtime.h's CPU stand-ins.
#include "cuda_runtime.h"

thread_local dim3_ threadIdx;
dim3_ blockIdx, blockDim;

namespace cpu_cuda {
std::barrier<>* block_barrier;
std::vector<double> slots;
}  // namespace cpu_cuda
