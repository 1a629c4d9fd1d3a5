// K1 at nl = 7: the 7-DoF SEA arm (the kernel: linearize.cuh).
#include "linearize.cuh"

ASLR_LINEARIZE_ENTRY(aslr_linearize_n7_f32, float, 7)
ASLR_LINEARIZE_ENTRY(aslr_linearize_n7_f64, double, 7)
