// K3 and K6 at nl = 7: the 7-DoF SEA arm unboxed without gaps, DDP's
// rollout (the kernel: rollout.cuh), a unit of its own so that nvcc
// compiles it beside rollout_n7.cu, whose C entries launch it.
#include "rollout.cuh"

ASLR_ROLLOUT_NDOF_UNIT(7, false, false)
