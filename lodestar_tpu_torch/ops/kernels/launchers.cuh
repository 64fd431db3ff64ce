// The launchers of the row kernels (fused_kernels.cu, tower_kernels.cu,
// library_kernels.cu): the kernels' parameter block and the launcher macro
// of a cooperative kernel (field_coop.cuh, tower_coop.cuh).
//
// Every launcher is extern "C" with a plain interface for ctypes: input
// and output pointer arrays, the row count, the int32 constant table, the
// stream.  It returns cudaGetLastError() of the launch.  attrs_NAME reads
// the kernel's function attributes (lf_func_attrs).

#pragma once

#include <cuda_runtime.h>

namespace {

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

// A kernel's cudaFuncGetAttributes into out: registers a thread, local
// (spill) bytes a thread, static shared bytes, the most threads a block,
// the most dynamic shared bytes (the analysis layer's launch-resource
// audit holds them against the launch configuration).
static int lf_func_attrs(const void* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

// One block of LAYOUT::THREADS per LAYOUT::ROWS rows; the rows' values, the
// constant table and every warp's scratch in dynamic shared memory (the
// attribute admits a layout above 48 KB, as lad2, lad3 and tower_fq12_mul
// have).  The kernel body casts the shared memory to LAYOUT and runs
// lfc::block_NAME on it, which masks the last block's missing rows (every
// thread reaches every __syncthreads).
#define LF_COOP_KERNEL(NAME, NIN, NOUT, LAYOUT)                                   \
  using NAME##_layout = LAYOUT;                                                   \
  __global__ void __launch_bounds__(NAME##_layout::THREADS, NAME##_layout::MIN_BLOCKS) \
      NAME##_k(Ptrs p, int n, const int* __restrict__ K) {                        \
    extern __shared__ __align__(16) int smem[];                                   \
    lfc::block_##NAME(p.in, p.out, n, (int)blockIdx.x, K,                         \
                      *reinterpret_cast<NAME##_layout*>(smem));                   \
  }                                                                               \
  extern "C" int launch_##NAME(void* const* ins, void* const* outs, int n,        \
                               const void* consts, void* stream) {                \
    if (n <= 0) return 0;                                                         \
    const Ptrs p = make_ptrs(ins, NIN, outs, NOUT);                               \
    const int bytes = static_cast<int>(sizeof(NAME##_layout));                    \
    cudaError_t e = cudaFuncSetAttribute(                                         \
        NAME##_k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);            \
    if (e != cudaSuccess) return static_cast<int>(e);                             \
    const int blocks = (n + NAME##_layout::ROWS - 1) / NAME##_layout::ROWS;       \
    NAME##_k<<<blocks, NAME##_layout::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>( \
        p, n, static_cast<const int*>(consts));                                   \
    return static_cast<int>(cudaGetLastError());                                  \
  }                                                                               \
  extern "C" int smem_bytes_##NAME() { return static_cast<int>(sizeof(NAME##_layout)); } \
  extern "C" int rows_per_block_##NAME() { return NAME##_layout::ROWS; }          \
  extern "C" int threads_per_block_##NAME() { return NAME##_layout::THREADS; }    \
  extern "C" int attrs_##NAME(int* out) {                                         \
    return lf_func_attrs(reinterpret_cast<const void*>(NAME##_k), out);           \
  }
