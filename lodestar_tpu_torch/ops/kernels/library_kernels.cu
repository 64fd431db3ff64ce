// The library kernel, for Hopper (sm_90a): the JAX library's Fq2 product
// tower.fq2_mul as one kernel.  It replaces the one instance of
// lodestar_tpu/ops/pallas_fuse.py pallas_fuse (the factory that replays an
// op's jaxpr inside one Pallas kernel), pallas_fuse(tower.fq2_mul) of
// analysis/pallas_audit.py: the same digits as the unfused op, bitwise.
// Its block body is field_coop.cuh's block_library_fq2_mul, in the JAX
// limbs digit algorithm (strict sums before the third product, the
// width-51 subtraction pad); tower_kernels.cu's tower_fq2_mul computes
// the same product by value with the Pallas algorithm, to other digits.
//
// Design: cooperative, as the fused and tower kernels (field_coop.cuh):
// one warp per Fq step, the digits across the lanes, each row's values
// and the block's constant table in shared memory, three stages separated
// by block syncs, lfc::LIB_FQ2MUL_ROWS rows of lfc::LIB_FQ2MUL_WARPS warps
// a block.  Its first version ran one thread a row, a serial chain of
// local-memory loads and stores.
//
// What bounds it on this card: integer multiply-adds, 3 x (2,500 for the
// schoolbook + 2,600 for the fold of 52 tail digits) and 2 x 150 + 2 x 200
// for the strict sums' and the subtractions' folds, against 1.2 KB of
// operands and result a row: the operation side of the roofline.
//
// The launcher is launchers.cuh's, under LF_KERNEL_library_fq2_mul
// (_build.py compiles this file once per kernel).

#include "launchers.cuh"

#ifdef LF_KERNEL_library_fq2_mul
#include "field_coop.cuh"
LF_COOP_KERNEL(library_fq2_mul, 2, 1, lfc::LibFq2MulBlock)
#endif
