// The ten fused kernels of the batched BLS verification path, for Hopper
// (sm_90a).  Each __global__ replaces one Pallas TPU kernel of the JAX
// package.
//
// All ten (the G2 ladder's round kernels lad1, lad2 and lad3,
// fq2pow16mul, fq2mul, pow16mul, mul, fq2sqr, fold and canon) are
// cooperative: one warp per Fq step, the digits across the lanes, each
// row's values (and the block's constant table, or the slices of it that
// fold and canon read) in shared memory (field_coop.cuh).  The ladder
// kernels and fq2pow16mul run one row a block on 8 or 4 warps; fq2mul,
// pow16mul, mul, fq2sqr, fold and canon, whose rows are short chains (1 to
// 6 stages), several rows a block where that pays for the table's staging
// (the *Block aliases of field_coop.cuh).  Their first versions ran one
// thread per row, which left 1 to 160 of the 132 SMs with one warp each at
// the paths' shapes, walking a serial chain of 1 to 33 Fq products, or
// canon's 260 dependent carry steps.
//
// What bounds them on this card: integer multiply-add throughput.  An Fq
// product is 2,500 digit multiply-adds for the schoolbook plus 2,600 for
// the fold through the RED rows, against 400 bytes of input per operand
// row, so every kernel but fold and canon does hundreds of int32
// operations per byte it moves and sits on the operation side of the
// roofline.  fold and canon (one fold and ~170 more multiply-adds a row)
// sit on the memory side; what holds canon above that bound is its chain
// of six exact ripples, each a few dependent warp steps.
//
// The launchers (launchers.cuh) are extern "C" with a plain interface for
// ctypes and return cudaGetLastError() of the launch.
//
// Each kernel sits under its own LF_KERNEL_<name> guard: _build.py
// compiles this file once per kernel, all ten nvcc processes at once, and
// links the objects into one library.

#include "launchers.cuh"

#ifdef LF_KERNEL_fold
#include "field_coop.cuh"
// Replaces fused_core.py _fold_k (f_fold): loose -> semi-strict, carry
// passes around a three-row fold, one step on one warp a row,
// lfc::FOLD_ROWS rows a block, the three RED rows read from global memory
// (LF_FOLD_K_STAGED=1: staged a block).  About 150 multiply-adds against
// 400 bytes a row: the memory side of the roofline, where at its path's
// 1,024 rows the launch itself (an empty kernel takes ~1.2 us) is most of
// the time.
LF_COOP_KERNEL(fold, 1, 1, lfc::FoldBlock)
#endif

#ifdef LF_KERNEL_mul
#include "field_coop.cuh"
// Replaces lodestar_tpu/ops/fused_core.py _mul_k (f_mul): Fq product of
// two loose rows, the two entry folds at once, then one product (the
// schedule beside lfc::MulStages), lfc::MUL_ROWS rows of lfc::MUL_WARPS
// warps a block.  Operation-bound: ~5,400 multiply-adds a row.
LF_COOP_KERNEL(mul, 2, 1, lfc::MulBlock)
#endif

#ifdef LF_KERNEL_fq2sqr
#include "field_coop.cuh"
// Replaces fused_core.py _fq2sqr_k (f2_sqr): Fq2 square plus the folded
// input as a second output, the entry folds, two Fq products and two
// small folds, at most 2 steps at once (the schedule beside
// lfc::Fq2SqrStages), lfc::FQ2SQR_ROWS rows of lfc::FQ2SQR_WARPS warps a
// block.  Operation-bound.
LF_COOP_KERNEL(fq2sqr, 1, 2, lfc::Fq2SqrBlock)
#endif

#ifdef LF_KERNEL_fq2mul
#include "field_coop.cuh"
// Replaces fused_core.py _fq2mul_k (f2_mul): Fq2 Karatsuba, the entry folds
// of a and b, three Fq products (at most 3 at once), two finishing folds
// (the schedule beside lfc::Fq2MulStages).  Its rows (256 to 2,322 on the
// path) are short chains, so a block holds lfc::FQ2MUL_ROWS rows of
// lfc::FQ2MUL_WARPS warps each.  Operation-bound.
LF_COOP_KERNEL(fq2mul, 2, 1, lfc::Fq2MulBlock)
#endif

#ifdef LF_KERNEL_pow16mul
#include "field_coop.cuh"
// Replaces fused_core.py _pow16mul_k (f_pow16mul): r^16 * t in Fq, the
// entry folds and five Fq products in sequence (the schedule beside
// lfc::Pow16MulStages), one warp a row, lfc::POW16_ROWS rows a block.
// Operation-bound.
LF_COOP_KERNEL(pow16mul, 2, 1, lfc::Pow16MulBlock)
#endif

#ifdef LF_KERNEL_fq2pow16mul
#include "field_coop.cuh"
// Replaces fused_core.py _fq2pow16mul_k (f2_pow16mul): r^16 * t in Fq2,
// four Fq2 squares and one Karatsuba, 11 Fq products a row in a chain
// that allows at most 3 at once (the schedule beside
// lfc::Fq2Pow16MulStages), so its block has lfc::POW_WARPS warps, fewer
// than the ladder's.  Operation-bound.
LF_COOP_KERNEL(fq2pow16mul, 2, 1, lfc::Fq2Pow16MulBlock)
#endif

#ifdef LF_KERNEL_canon
#include "field_coop.cuh"
// Replaces fused_core.py _canon_k (f_canon): loose -> the canonical
// residue.  One warp a row, lfc::CANON_ROWS rows a block: the entry fold,
// the exact ripple of x to 51 digits, the Barrett quotient's three digits
// (in every lane's registers), then the exact ripples of q p, x - q p and
// the conditional subtractions of 2p and p, each its carry passes and one
// step that resolves the 0/1 carries from the OR of the digit pairs'
// flags (lfc::canon_row).  Its table slices are read from global memory
// (LF_CANON_K_STAGED=1: staged a block), its registers sized for 2,048
// threads a SM.  Bound by the bytes (400 in and out a row) at ~2,800
// multiply-adds a row; what holds it above that is the integer
// instructions of its ripples (~800 a row on the warp).
LF_COOP_KERNEL(canon, 1, 1, lfc::CanonBlock)
#endif

#ifdef LF_KERNEL_lad1
#include "field_coop.cuh"
// Replaces lodestar_tpu/ops/fused_ladder.py _lad1_k: round 1 of the
// complete G2 double-and-add (z1^2, z2^2; x^2, y^2, y*z of both
// doublings): 6 Fq2 squares and 2 Karatsubas, 18 Fq products a row, at
// most 12 at once (the schedule beside lfc::Lad1Stages).  Operation-bound.
LF_COOP_KERNEL(lad1, 6, 8, lfc::Lad1Block)
#endif

#ifdef LF_KERNEL_lad2
#include "field_coop.cuh"
// Replaces fused_ladder.py _lad2_k: the u/s cross terms and the doubling
// glue (e, x3, d - x3, 8c) of both doublings, 24 Fq products a row, at
// most 8 at once (the schedule beside lfc::Lad2Stages).  Operation-bound.
LF_COOP_KERNEL(lad2, 10, 12, lfc::Lad2Block)
#endif

#ifdef LF_KERNEL_lad3
#include "field_coop.cuh"
// Replaces fused_ladder.py _lad3_k: rounds 3-6 of the complete add and
// y3/z3 of both doublings, 33 Fq products a row, at most 6 at once (the
// schedule beside lfc::Lad3Stages).  Operation-bound.
LF_COOP_KERNEL(lad3, 16, 9, lfc::Lad3Block)
#endif
