// K3 and K6 at nl = 7: the 7-DoF SEA arm, unboxed, with gaps (the kernel:
// rollout.cuh); its C entries also launch the variants of
// rollout_n7_sea.cu and rollout_n7_box.cu.
#include "rollout.cuh"

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_n7_f32, float, 7, aslr::kShared)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_n7_f64, double, 7, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_n7_f32, float, 7, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_n7_f64, double, 7, aslr::kShared)
ASLR_ROLLOUT_LAUNCH_ENTRY(aslr_rollout_n7_launch, 7)
