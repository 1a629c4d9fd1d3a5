// K1 at nl = 3: the 3-DoF SEA arm (the kernel: linearize.cuh).
#include "linearize.cuh"

ASLR_LINEARIZE_ENTRY(aslr_linearize_n3_f32, float, 3)
ASLR_LINEARIZE_ENTRY(aslr_linearize_n3_f64, double, 3)
