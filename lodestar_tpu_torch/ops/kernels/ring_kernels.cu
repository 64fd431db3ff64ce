// The ring all-gather hop of the sharded tier, for Hopper (sm_90a).
//
// Replaces lodestar_tpu/ops/pallas_ring.py _ring_gather_kernel (reached
// from ring_all_gather).  The TPU kernel is one persistent program per
// shard: a local DMA seeds slot s of the output, then n-1 remote DMAs each
// push slot (s - k) mod n into the same slot of the right neighbour, with
// DMA semaphores ordering the hops across chips.  Here each copy is one
// launch of ring_hop_k on the sending shard's stream, from a local slot to
// a slot that may lie on another card (a peer pointer over NVLink); the
// order across shards lives in CUDA events recorded and waited by the
// wrapper (ops/ring_gather.py).  A persistent kernel spinning on flags in
// peer memory, as the semaphores do, would deadlock when two logical
// shards share one card and their blocks are not resident together.
//
// What bounds it: the bytes.  A chunk is 2,400 bytes (a (6, 2, 50) float32
// GT partial) or 8 (the two verdict bits), so one hop is all launch and
// copy latency.  The first version, one block of 256 threads in a
// grid-stride loop of 4-byte copies with 64-bit indices, took up to three
// dependent load-store rounds a thread and lost to Tensor.copy_; this one
// copies in one pass, 16-byte float4 accesses where both pointers allow,
// a grid sized to the chunk and 32-bit indices (ring_hop.cuh: the plan
// and the per-thread body, which the host test walks with g++).
//
// Launchers: extern "C", returning cudaGetLastError() of the launch.
// ring_enable_peer makes `peer`'s memory addressable from `dev` (an
// "already enabled" return is not an error) and restores the calling
// thread's current device.  launch_empty launches an empty kernel of one
// block, the floor a hop's time is read against.

#include <cuda_runtime.h>

#ifdef LF_KERNEL_ring_hop

#include "ring_hop.cuh"

namespace {

template <class I, int N>
__global__ void __launch_bounds__(lr::THREADS)
    ring_hop_k(const float* __restrict__ src, float* __restrict__ dst, I nvec, I items) {
  const I T = (I)gridDim.x * (I)blockDim.x;
  lr::hop_thread<I, N>(src, dst, nvec, items, (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x, T);
}

__global__ void empty_k() {}

}  // namespace

extern "C" int launch_ring_hop(const void* src, void* dst, long long n, void* stream) {
  if (n <= 0) return 0;
  const lr::Plan p = lr::plan(src, dst, n);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.one_block)
    ring_hop_k<int, 1><<<1, p.threads, 0, st>>>(s, d, (int)p.nvec, (int)p.items);
  else if (p.narrow)
    ring_hop_k<int, lr::ITEMS><<<(unsigned)p.blocks, p.threads, 0, st>>>(s, d, (int)p.nvec,
                                                                         (int)p.items);
  else
    ring_hop_k<long long, lr::ITEMS><<<(unsigned)p.blocks, p.threads, 0, st>>>(s, d, p.nvec,
                                                                               p.items);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_empty(void* stream) {
  empty_k<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ring_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the (non-sticky) error it leaves behind
      err = cudaSuccess;
    }
  }
  cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

#endif  // LF_KERNEL_ring_hop
