// The four tower kernels of the XLA-graph verification path, for Hopper
// (sm_90a).  Each __global__ replaces one Pallas TPU kernel of
// lodestar_tpu/ops/pallas_tower.py and runs the row body of the same name
// in tower.cuh.
//
// Design (first, simple version, as fused_kernels.cu): one thread per row,
// 32 threads a block, every index checked against n; a row's digits live
// in per-thread int32 arrays in local memory, the Fq products are plain
// schoolbook loops of int32 multiply-adds, and the Fq2 / Fq6 products are
// real calls.  No shared memory, no tensor cores.
//
// What bounds them on this card: integer multiply-add throughput.  One Fq
// product is 2,500 digit multiply-adds for the schoolbook and 2,600 for the
// fold; every add and subtract folds its 51 columns through the RED rows
// too (100 multiply-adds).  Against 400 bytes an operand row that is
// hundreds of operations a byte: the operation side of the roofline.  In
// this version each thread is instead bound by its own serial chain of
// local-memory loads and stores, so the rows in flight (1 to ~1,500 on
// the path) set the speed.
//
// Launchers: extern "C", (ins, outs, n, constant table, stream), returning
// cudaGetLastError() of the launch.  Each kernel sits under its own
// LF_KERNEL_<name> guard; _build.py compiles this file once per kernel.

#include <cuda_runtime.h>

#include "tower.cuh"

#ifndef LF_THREADS
#define LF_THREADS 32  // another block size only for the card tests' variants
#endif

namespace {

constexpr int kThreads = LF_THREADS;

struct Ptrs {
  const float* in[2];
  float* out[1];
};

}  // namespace

#define LF_LAUNCHER(NAME, NIN)                                                    \
  extern "C" int launch_##NAME(void* const* ins, void* const* outs, int n,        \
                               const void* consts, void* stream) {                \
    if (n <= 0) return 0;                                                         \
    Ptrs p = {};                                                                  \
    for (int i = 0; i < NIN; ++i) p.in[i] = static_cast<const float*>(ins[i]);    \
    p.out[0] = static_cast<float*>(outs[0]);                                      \
    const int blocks = (n + kThreads - 1) / kThreads;                             \
    NAME##_k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(         \
        p, n, static_cast<const int*>(consts));                                   \
    return static_cast<int>(cudaGetLastError());                                  \
  }

#define LF_ROW_KERNEL(NAME)                                                       \
  __global__ void NAME##_k(Ptrs p, int n, const int* __restrict__ K) {            \
    const int row = blockIdx.x * blockDim.x + threadIdx.x;                        \
    if (row < n) lf::row_##NAME(p.in, p.out, row, K);                             \
  }

#ifdef LF_KERNEL_tower_fq2_mul
// Replaces lodestar_tpu/ops/pallas_tower.py _fq2_mul_kernel (fq2_mul):
// Karatsuba, 3 Fq products and 5 folded adds/subtracts a row.
LF_ROW_KERNEL(tower_fq2_mul)
LF_LAUNCHER(tower_fq2_mul, 2)
#endif

#ifdef LF_KERNEL_tower_fq2_sqr
// Replaces pallas_tower.py _fq2_sqr_kernel (fq2_sqr): 2 Fq products.
LF_ROW_KERNEL(tower_fq2_sqr)
LF_LAUNCHER(tower_fq2_sqr, 1)
#endif

#ifdef LF_KERNEL_tower_fq6_mul
// Replaces pallas_tower.py _fq6_mul_kernel (fq6_mul): 6 Karatsubas (18 Fq
// products) and the xi recombination.
LF_ROW_KERNEL(tower_fq6_mul)
LF_LAUNCHER(tower_fq6_mul, 2)
#endif

#ifdef LF_KERNEL_tower_fq12_mul
// Replaces pallas_tower.py _fq12_mul_kernel (fq12_mul): 3 Fq6 products
// (54 Fq products) a row, the heaviest body of the port.
LF_ROW_KERNEL(tower_fq12_mul)
LF_LAUNCHER(tower_fq12_mul, 2)
#endif
