// The ring hop's copy, as a plan and a per-thread body that are
// __host__ __device__: ring_kernels.cu launches them, host_shim.cpp walks
// the same plan's threads with g++ for the CPU test.
//
// A chunk of n float32 is cut into items: 16-byte float4 items when both
// pointers are 16-byte aligned, then the scalar tail (every float when
// they are not: a slot of the (n, 2) verdict-bits stack starts at 8 x slot
// bytes, so every odd slot is only 8-byte aligned).  The grid is sized to
// the items: up to THREADS of them, one block of as many threads, rounded
// up to a warp, one item each (the 2,400-byte GT partial: 150 threads, one
// load and one store each, no loop); above that blocks of THREADS threads
// with up to ITEMS items a thread, all of a thread's loads issued before
// its stores.  Indices are 32-bit where the items allow (I = int), else 64.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define LR_HD static __host__ __device__ __forceinline__

namespace lr {

#ifdef __CUDACC__
typedef float4 vec4;
#else
struct alignas(16) vec4 {
  float x, y, z, w;
};
#endif

#ifndef LF_RING_VEC
#define LF_RING_VEC 1  // 0 (a variant for the card tests): every float a scalar item
#endif

constexpr int THREADS = 256;  // a block's threads at most
constexpr int ITEMS = 4;      // a thread's items at most

struct Plan {
  long long nvec;   // float4 items, the first 4 nvec floats
  long long items;  // nvec and then one item a float of the tail
  long long blocks;
  int threads;      // a block
  bool narrow;      // 32-bit indices will do
  bool one_block;   // one item a thread
};

LR_HD Plan plan(const void* src, const void* dst, long long n) {
  Plan p;
  const bool vec = LF_RING_VEC && (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0;
  p.nvec = vec ? n / 4 : 0;
  p.items = p.nvec + (n - 4 * p.nvec);
  if (p.items <= THREADS) {
    p.blocks = 1;
    p.threads = (int)((p.items + 31) / 32 * 32);
  } else {
    p.threads = THREADS;
    p.blocks = (p.items + (long long)THREADS * ITEMS - 1) / ((long long)THREADS * ITEMS);
  }
  p.one_block = p.blocks == 1 && p.items <= p.threads;
  p.narrow = p.items + (long long)THREADS * ITEMS < (1LL << 30);
  return p;
}

// Thread t of T in all copies items t, t + T, .. (< items), N at most
// (1 when one block holds them all, else ITEMS): loads, then stores.
template <class I, int N>
LR_HD void hop_thread(const float* src, float* dst, I nvec, I items, I t, I T) {
  vec4 v[N];
  float f[N];
  const float* tail = src + 4 * nvec;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int j = 0; j < N; ++j) {
    const I i = t + (I)j * T;
    if (i < nvec)
      v[j] = reinterpret_cast<const vec4*>(src)[i];
    else if (i < items)
      f[j] = tail[i - nvec];
  }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int j = 0; j < N; ++j) {
    const I i = t + (I)j * T;
    if (i < nvec)
      reinterpret_cast<vec4*>(dst)[i] = v[j];
    else if (i < items)
      dst[4 * nvec + (i - nvec)] = f[j];
  }
}

}  // namespace lr
