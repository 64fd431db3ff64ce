// The ten fused kernels of the batched BLS verification path, for Hopper
// (sm_90a).  Each __global__ replaces one Pallas TPU kernel of the JAX
// package and runs the row body of the same name in field.cuh.
//
// Design (first, simple version): one thread per row of the flat row
// axis, 32 threads a block (the main path has only 512 to 2,560 rows, so
// small blocks spread them over more SMs), every index checked against n.
// A row's digits live in per-thread int32 arrays in local memory; the
// 50x50 digit product is a plain schoolbook loop of int32 multiply-adds,
// and the heavy steps are real calls rather than inlined copies.  There
// is no shared memory and no tensor-core use.
//
// What bounds them on this card: integer multiply-add throughput.  An Fq
// product is 2,500 digit multiply-adds for the schoolbook plus 2,600 for
// the fold through the RED rows, against 400 bytes of input per operand
// row, so every kernel but fold does hundreds of int32 operations per
// byte it moves and sits on the operation side of the roofline.  In this
// version each thread is bound by its own serial chain of local-memory
// loads and stores instead; a warp per row, or tensor-core products of
// the 8-bit digits, are the ways to approach the bound.
//
// Every launcher is extern "C" with a plain interface for ctypes: input
// and output pointer arrays, the row count, the int32 constant table, the
// stream.  It returns cudaGetLastError() of the launch.
//
// Each kernel sits under its own LF_KERNEL_<name> guard: _build.py
// compiles this file once per kernel, all ten nvcc processes at once, and
// links the objects into one library.

#include <cuda_runtime.h>

#include "field.cuh"

#ifndef LF_THREADS
#define LF_THREADS 32  // another block size only for the card tests' variants
#endif

namespace {

constexpr int kThreads = LF_THREADS;

struct Ptrs {
  const float* in[16];
  float* out[12];
};

// Kernel parameters: the ctypes pointer arrays copied into one struct.
static Ptrs make_ptrs(void* const* ins, int nin, void* const* outs, int nout) {
  Ptrs p = {};
  for (int i = 0; i < nin; ++i) p.in[i] = static_cast<const float*>(ins[i]);
  for (int i = 0; i < nout; ++i) p.out[i] = static_cast<float*>(outs[i]);
  return p;
}

}  // namespace

#define LF_LAUNCHER(NAME, NIN, NOUT)                                              \
  extern "C" int launch_##NAME(void* const* ins, void* const* outs, int n,        \
                               const void* consts, void* stream) {                \
    if (n <= 0) return 0;                                                         \
    const Ptrs p = make_ptrs(ins, NIN, outs, NOUT);                               \
    const int blocks = (n + kThreads - 1) / kThreads;                             \
    NAME##_k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(         \
        p, n, static_cast<const int*>(consts));                                   \
    return static_cast<int>(cudaGetLastError());                                  \
  }

#ifdef LF_KERNEL_mul
// Replaces lodestar_tpu/ops/fused_core.py _mul_k (f_mul): Fq product of
// two loose rows.  Operation-bound: ~5,400 multiply-adds a row.
__global__ void mul_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_mul(p.in, p.out, row, K);
}
LF_LAUNCHER(mul, 2, 1)
#endif

#ifdef LF_KERNEL_fq2mul
// Replaces fused_core.py _fq2mul_k (f2_mul): Fq2 Karatsuba, three Fq
// products.  Operation-bound.
__global__ void fq2mul_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_fq2mul(p.in, p.out, row, K);
}
LF_LAUNCHER(fq2mul, 2, 1)
#endif

#ifdef LF_KERNEL_fq2sqr
// Replaces fused_core.py _fq2sqr_k (f2_sqr): Fq2 square plus the folded
// input as a second output.  Operation-bound.
__global__ void fq2sqr_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_fq2sqr(p.in, p.out, row, K);
}
LF_LAUNCHER(fq2sqr, 1, 2)
#endif

#ifdef LF_KERNEL_pow16mul
// Replaces fused_core.py _pow16mul_k (f_pow16mul): r^16 * t in Fq, five
// Fq products in sequence.  Operation-bound.
__global__ void pow16mul_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_pow16mul(p.in, p.out, row, K);
}
LF_LAUNCHER(pow16mul, 2, 1)
#endif

#ifdef LF_KERNEL_fq2pow16mul
// Replaces fused_core.py _fq2pow16mul_k (f2_pow16mul): r^16 * t in Fq2,
// four Fq2 squares and one Karatsuba.  Operation-bound.
__global__ void fq2pow16mul_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_fq2pow16mul(p.in, p.out, row, K);
}
LF_LAUNCHER(fq2pow16mul, 2, 1)
#endif

#ifdef LF_KERNEL_fold
// Replaces fused_core.py _fold_k (f_fold): loose -> semi-strict, two carry
// passes around a three-row fold.  About 150 multiply-adds against 400
// bytes a row: close to the memory side of the roofline.
__global__ void fold_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_fold(p.in, p.out, row, K);
}
LF_LAUNCHER(fold, 1, 1)
#endif

#ifdef LF_KERNEL_canon
// Replaces fused_core.py _canon_k (f_canon): fold, 51-digit ripple,
// Barrett quotient (mu = floor(2^424/p)), two conditional subtractions.
// The five ripples are serial carry chains a thread walks digit by digit:
// latency-bound per thread, hidden only by running many rows at once.
__global__ void canon_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_canon(p.in, p.out, row, K);
}
LF_LAUNCHER(canon, 1, 1)
#endif

#ifdef LF_KERNEL_lad1
// Replaces lodestar_tpu/ops/fused_ladder.py _lad1_k: round 1 of the
// complete G2 double-and-add (z1^2, z2^2; x^2, y^2, y*z of both
// doublings): 6 Fq2 squares and 2 Karatsubas a row.  Operation-bound.
__global__ void lad1_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_lad1(p.in, p.out, row, K);
}
LF_LAUNCHER(lad1, 6, 8)
#endif

#ifdef LF_KERNEL_lad2
// Replaces fused_ladder.py _lad2_k: the u/s cross terms and the doubling
// glue (e, x3, d - x3, 8c) of both doublings.  Operation-bound.
__global__ void lad2_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_lad2(p.in, p.out, row, K);
}
LF_LAUNCHER(lad2, 10, 12)
#endif

#ifdef LF_KERNEL_lad3
// Replaces fused_ladder.py _lad3_k: rounds 3-6 of the complete add and
// y3/z3 of both doublings.  Operation-bound.
__global__ void lad3_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_lad3(p.in, p.out, row, K);
}
LF_LAUNCHER(lad3, 16, 9)
#endif
