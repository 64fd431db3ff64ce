// The library kernel, for Hopper (sm_90a): the JAX library's Fq2 product
// tower.fq2_mul as one kernel.  It replaces the one instance of
// lodestar_tpu/ops/pallas_fuse.py pallas_fuse (the factory that replays an
// op's jaxpr inside one Pallas kernel), pallas_fuse(tower.fq2_mul) of
// analysis/pallas_audit.py: the same digits as the unfused op, bitwise.
// The row body is limbs.cuh's row_library_fq2_mul, in the JAX limbs digit
// algorithm; tower_kernels.cu's tower_fq2_mul computes the same product by
// value with the Pallas algorithm, to other digits.
//
// Design (first, simple version, as the other row kernels): one thread per
// row, 32 threads a block, every index checked against n; a row's digits in
// per-thread int32 arrays, the Fq products plain schoolbook loops of int32
// multiply-adds, the heavy steps real calls.  No shared memory.
//
// What bounds it on this card: integer multiply-adds, 3 x (2,500 for the
// schoolbook + 2,600 for the fold of 52 tail digits) and 2 x 150 + 2 x 200
// for the strict sums' and the subtractions' folds, against 1.2 KB of
// operands and result a row: the operation side of the roofline.  In this
// version each thread is bound by its own serial chain of local-memory
// loads and stores.
//
// Launcher: extern "C", (ins, outs, n, constant table, stream), returning
// cudaGetLastError() of the launch, under LF_KERNEL_library_fq2_mul
// (_build.py compiles this file once per kernel).

#include <cuda_runtime.h>

#include "limbs.cuh"

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

#ifdef LF_KERNEL_library_fq2_mul
__global__ void library_fq2_mul_k(Ptrs p, int n, const int* __restrict__ K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) lf::row_library_fq2_mul(p.in, p.out, row, K);
}

extern "C" int launch_library_fq2_mul(void* const* ins, void* const* outs, int n,
                                      const void* consts, void* stream) {
  if (n <= 0) return 0;
  Ptrs p = {};
  for (int i = 0; i < 2; ++i) p.in[i] = static_cast<const float*>(ins[i]);
  p.out[0] = static_cast<float*>(outs[0]);
  const int blocks = (n + kThreads - 1) / kThreads;
  library_fq2_mul_k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, n, static_cast<const int*>(consts));
  return static_cast<int>(cudaGetLastError());
}
#endif
