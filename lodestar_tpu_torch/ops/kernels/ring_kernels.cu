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
// copy latency; one block of 256 threads, a grid-stride loop of 4-byte
// loads and stores, is enough.
//
// Launchers: extern "C", returning cudaGetLastError() of the launch.
// ring_enable_peer makes `peer`'s memory addressable from `dev` (an
// "already enabled" return is not an error) and restores the calling
// thread's current device.

#include <cuda_runtime.h>

#ifdef LF_KERNEL_ring_hop

namespace {

constexpr int kThreads = 256;

__global__ void ring_hop_k(const float* __restrict__ src, float* __restrict__ dst,
                           long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = src[i];
  }
}

}  // namespace

extern "C" int launch_ring_hop(const void* src, void* dst, long long n, void* stream) {
  if (n <= 0) return 0;
  ring_hop_k<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n);
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
