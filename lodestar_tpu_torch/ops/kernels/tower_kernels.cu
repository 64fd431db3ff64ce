// The four tower kernels of the XLA-graph verification path, for Hopper
// (sm_90a).  Each __global__ replaces one Pallas TPU kernel of
// lodestar_tpu/ops/pallas_tower.py.
//
// All four are cooperative (tower_coop.cuh over field_coop.cuh): one warp
// per Fq step, the digits across the lanes, each row's values and the
// block's constant table in shared memory, stages separated by block
// syncs.  The Fq12 product runs one row a block on lfc::TOWER_FQ12_WARPS
// warps: its 54 products and 224 folds in 9 stages, the three Fq6 products
// interleaved so that up to 24 products run at once; its path launches it
// at 129 rows (one wave on 132 SMs) and at 1.  The Fq6 product runs the
// same Fq6 levels for one product, 18 products and 64 folds in 7 stages,
// one row a block on lfc::TOWER_FQ6_WARPS warps; its path (the final
// exponentiation's Fq12 inversion) launches it at 1 row.  The Fq2 product
// (three stages) and the Fq2 square (two) run several rows a block
// (lfc::TOWER_FQ2_ROWS of lfc::TOWER_FQ2_WARPS warps, and
// lfc::TOWER_FQ2SQR_ROWS of lfc::TOWER_FQ2SQR_WARPS).
//
// What bounds them on this card: integer multiply-add throughput.  One Fq
// product is 2,500 digit multiply-adds for the schoolbook and 2,600 for the
// fold; every add and subtract folds its 51 columns through the RED rows
// too (100 multiply-adds).  Against 400 bytes an operand row that is
// hundreds of operations a byte: the operation side of the roofline.
//
// The launchers are launchers.cuh's.  Each kernel sits under its own
// LF_KERNEL_<name> guard; _build.py compiles this file once per kernel.

#include "launchers.cuh"

#ifdef LF_KERNEL_tower_fq2_mul
#include "tower_coop.cuh"
// Replaces lodestar_tpu/ops/pallas_tower.py _fq2_mul_kernel (fq2_mul):
// Karatsuba, 3 Fq products and 5 folded adds/subtracts a row in three
// stages (the schedule beside lfc::tw_karatsuba), lfc::TOWER_FQ2_ROWS rows
// of lfc::TOWER_FQ2_WARPS warps a block.  Operation-bound.
LF_COOP_KERNEL(tower_fq2_mul, 2, 1, lfc::TowerFq2MulBlock)
#endif

#ifdef LF_KERNEL_tower_fq2_sqr
#include "tower_coop.cuh"
// Replaces pallas_tower.py _fq2_sqr_kernel (fq2_sqr): 2 Fq products and 3
// folded adds/subtracts a row in two stages (the schedule beside
// lfc::TowerFq2SqrStages), lfc::TOWER_FQ2SQR_ROWS rows of
// lfc::TOWER_FQ2SQR_WARPS warps a block.  Operation-bound.
LF_COOP_KERNEL(tower_fq2_sqr, 1, 1, lfc::TowerFq2SqrBlock)
#endif

#ifdef LF_KERNEL_tower_fq6_mul
#include "tower_coop.cuh"
// Replaces pallas_tower.py _fq6_mul_kernel (fq6_mul): 6 Karatsubas (18 Fq
// products) and the xi recombination, 64 folds, a row in 7 stages (the
// schedule beside lfc::fq6_level), one row a block of lfc::TOWER_FQ6_WARPS
// warps.  Operation-bound.
LF_COOP_KERNEL(tower_fq6_mul, 2, 1, lfc::TowerFq6MulBlock)
#endif

#ifdef LF_KERNEL_tower_fq12_mul
#include "tower_coop.cuh"
// Replaces pallas_tower.py _fq12_mul_kernel (fq12_mul): 3 Fq6 products
// (54 Fq products, 224 folds) a row in 9 stages (the schedule beside
// lfc::TowerFq12MulStages), one row a block of lfc::TOWER_FQ12_WARPS
// warps.  Operation-bound.
LF_COOP_KERNEL(tower_fq12_mul, 2, 1, lfc::TowerFq12MulBlock)
#endif
