// K3 and K6 with a per-knot problem's tables (the [T, 12] target table, the
// [T, NU] box tables) at nl = 3: the 3-DoF SEA arm, unboxed, with gaps (the
// kernel: rollout.cuh, its instances of table mode kTables; the shared
// problem's instances are in rollout_n3.cu), a unit of its own so that nvcc
// compiles it beside them.
#include "rollout.cuh"

ASLR_ROLLOUT2_ENTRY(aslr_rollout2_tables_n3_f32, float, 3, aslr::kTables)
ASLR_ROLLOUT2_ENTRY(aslr_rollout2_tables_n3_f64, double, 3, aslr::kTables)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_tables_n3_f32, float, 3, aslr::kTables)
ASLR_ROLLOUT1_ENTRY(aslr_rollout1_tables_n3_f64, double, 3, aslr::kTables)
