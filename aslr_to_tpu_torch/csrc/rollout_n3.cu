// K3 and K6 at nl = 3: the 3-DoF SEA arm, unboxed, with gaps (the kernel:
// rollout.cuh); its C entries also launch the variants of
// rollout_n3_sea.cu and rollout_n3_box.cu.
#include "rollout.cuh"

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_n3_f32, float, 3, aslr::kShared)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_n3_f64, double, 3, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_n3_f32, float, 3, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_n3_f64, double, 3, aslr::kShared)
