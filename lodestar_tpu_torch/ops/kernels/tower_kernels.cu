// The four tower kernels of the XLA-graph verification path, for Hopper
// (sm_90a).  Each __global__ replaces one Pallas TPU kernel of
// lodestar_tpu/ops/pallas_tower.py.
//
// tower_fq2_mul and tower_fq12_mul are cooperative (tower_coop.cuh over
// field_coop.cuh): one warp per Fq step, the digits across the lanes, each
// row's values and the block's constant table in shared memory, stages
// separated by block syncs.  The Fq12 product runs one row a block on
// lfc::TOWER_FQ12_WARPS warps: its 54 products and 224 folds in 9 stages,
// the three Fq6 products interleaved so that up to 24 products run at
// once; its path launches it at 129 rows (one wave on 132 SMs) and at 1.
// The Fq2 product, three stages a row, runs lfc::TOWER_FQ2_ROWS rows of
// lfc::TOWER_FQ2_WARPS warps a block.  One thread a row had left the
// Fq12 product's 129 rows 129 threads, each walking its row's chain of 54
// products one after the other in local memory.
//
// tower_fq2_sqr and tower_fq6_mul (first, simple version): one thread per
// row, 32 threads a block, every index checked against n; a row's digits
// in per-thread int32 arrays in local memory, the Fq products plain
// schoolbook loops of int32 multiply-adds, the Fq2 / Fq6 products real
// calls (tower.cuh).
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
#include "tower.cuh"

#define LF_ROW_KERNEL(NAME)                                                       \
  __global__ void NAME##_k(Ptrs p, int n, const int* __restrict__ K) {            \
    const int row = blockIdx.x * blockDim.x + threadIdx.x;                        \
    if (row < n) lf::row_##NAME(p.in, p.out, row, K);                             \
  }

#ifdef LF_KERNEL_tower_fq2_mul
#include "tower_coop.cuh"
// Replaces lodestar_tpu/ops/pallas_tower.py _fq2_mul_kernel (fq2_mul):
// Karatsuba, 3 Fq products and 5 folded adds/subtracts a row in three
// stages (the schedule beside lfc::tw_karatsuba), lfc::TOWER_FQ2_ROWS rows
// of lfc::TOWER_FQ2_WARPS warps a block.  Operation-bound.
LF_COOP_KERNEL(tower_fq2_mul, 2, 1, lfc::TowerFq2MulBlock)
#endif

#ifdef LF_KERNEL_tower_fq2_sqr
// Replaces pallas_tower.py _fq2_sqr_kernel (fq2_sqr): 2 Fq products.
LF_ROW_KERNEL(tower_fq2_sqr)
LF_LAUNCHER(tower_fq2_sqr, 1, 1)
#endif

#ifdef LF_KERNEL_tower_fq6_mul
// Replaces pallas_tower.py _fq6_mul_kernel (fq6_mul): 6 Karatsubas (18 Fq
// products) and the xi recombination.
LF_ROW_KERNEL(tower_fq6_mul)
LF_LAUNCHER(tower_fq6_mul, 2, 1)
#endif

#ifdef LF_KERNEL_tower_fq12_mul
#include "tower_coop.cuh"
// Replaces pallas_tower.py _fq12_mul_kernel (fq12_mul): 3 Fq6 products
// (54 Fq products, 224 folds) a row in 9 stages (the schedule beside
// lfc::TowerFq12MulStages), one row a block of lfc::TOWER_FQ12_WARPS
// warps.  Operation-bound.
LF_COOP_KERNEL(tower_fq12_mul, 2, 1, lfc::TowerFq12MulBlock)
#endif
