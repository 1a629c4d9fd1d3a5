// K1 at nl = 2: the 2-DoF VSA and SEA arms (the kernel: linearize.cuh).
#include "linearize.cuh"

ASLR_LINEARIZE_ENTRY(aslr_linearize_f32, float, 2)
ASLR_LINEARIZE_ENTRY(aslr_linearize_f64, double, 2)
