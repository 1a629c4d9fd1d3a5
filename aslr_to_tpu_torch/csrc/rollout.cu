// K3 and K6 at nl = 2: the 2-DoF VSA and SEA arms, every variant (the
// kernel: rollout.cuh), and the block's dynamic shared memory of every
// instance.
#include "rollout.cuh"

// the dynamic shared memory of one block of K3 (ntrials 2) or K6 (1) at the
// chain length nl (2, 3 or 7), VSA or SEA, with or without gaps, K3 in its
// wide layout (wide 1, nl 7) or its general one, for 4- or 8-byte scalars,
// in bytes; -1 if there is none
extern "C" int aslr_rollout_smem(int nl, int ntrials, int sea, int gaps, int wide,
                                 int itemsize) {
  if (ntrials != 1 && ntrials != 2) return aslr::kNoInstance;
  if (itemsize == 4) return aslr::roll_bytes<float>(nl, ntrials, sea, gaps, wide);
  return itemsize == 8 ? aslr::roll_bytes<double>(nl, ntrials, sea, gaps, wide)
                       : aslr::kNoInstance;
}

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f32, float, 2, aslr::kShared)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_f64, double, 2, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f32, float, 2, aslr::kShared)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_f64, double, 2, aslr::kShared)
