// Host build of the row kernels' block bodies (field_coop.cuh,
// tower_coop.cuh) and of the ring hop's plan and per-thread body
// (ring_hop.cuh) with a plain C interface, for the CPU parity test: the
// same arithmetic the CUDA kernels run, on the CPU.  The cooperative
// bodies of the fifteen row kernels walk their blocks, and in each its
// rows' warps and lanes, in turn (backwards under -DLC_HOST_REVERSED), over
// one host copy of their shared-memory layout at the kernels' warp and row
// counts, filled with -1 before each block so that a read of a value the
// block did not write shows; the hop walks its grid's threads.  Built with
// g++ by tests/test_torch_kernel_host.py; not part of the device path.

#include <algorithm>
#include <memory>

#include "field_coop.cuh"
#include "ring_hop.cuh"
#include "tower_coop.cuh"

#ifdef LC_HOST_REVERSED
#define LF_HOST_BLOCK(i, blocks) ((blocks) - 1 - (i))
#else
#define LF_HOST_BLOCK(i, blocks) (i)
#endif

#define LF_HOST_COOP(NAME, LAYOUT)                                           \
  extern "C" int host_##NAME(void* const* ins, void* const* outs, int n,     \
                             const void* consts) {                           \
    const float* in[16] = {};                                                \
    float* out[12] = {};                                                     \
    for (int i = 0; i < 16 && ins[i]; ++i) in[i] = (const float*)ins[i];     \
    for (int i = 0; i < 12 && outs[i]; ++i) out[i] = (float*)outs[i];        \
    std::unique_ptr<lfc::LAYOUT> s(new lfc::LAYOUT());                       \
    const int blocks = (n + lfc::LAYOUT::ROWS - 1) / lfc::LAYOUT::ROWS;      \
    for (int i = 0; i < blocks; ++i) {                                       \
      std::fill_n(reinterpret_cast<int*>(s.get()), sizeof(lfc::LAYOUT) / sizeof(int), -1); \
      lfc::block_##NAME(in, out, n, LF_HOST_BLOCK(i, blocks), (const int*)consts, *s); \
    }                                                                        \
    return 0;                                                                \
  }                                                                          \
  extern "C" int host_rows_per_block_##NAME() { return lfc::LAYOUT::ROWS; }

LF_HOST_COOP(mul, MulBlock)
LF_HOST_COOP(fq2mul, Fq2MulBlock)
LF_HOST_COOP(fq2sqr, Fq2SqrBlock)
LF_HOST_COOP(pow16mul, Pow16MulBlock)
LF_HOST_COOP(fq2pow16mul, Fq2Pow16MulBlock)
LF_HOST_COOP(fold, FoldBlock)
LF_HOST_COOP(canon, CanonBlock)
LF_HOST_COOP(lad1, Lad1Block)
LF_HOST_COOP(lad2, Lad2Block)
LF_HOST_COOP(lad3, Lad3Block)
LF_HOST_COOP(tower_fq2_mul, TowerFq2MulBlock)
LF_HOST_COOP(tower_fq2_sqr, TowerFq2SqrBlock)
LF_HOST_COOP(tower_fq6_mul, TowerFq6MulBlock)
LF_HOST_COOP(tower_fq12_mul, TowerFq12MulBlock)
LF_HOST_COOP(library_fq2_mul, LibFq2MulBlock)

// The ring hop: launch_ring_hop's plan for these pointers, every thread of
// its grid in turn (backwards under -DLC_HOST_REVERSED), the same index
// width; returns the plan's float4 items.
template <class I, int N>
static void host_hop(const float* src, float* dst, const lr::Plan& p) {
  const long long T = p.blocks * p.threads;
  for (long long k = 0; k < T; ++k) {
#ifdef LC_HOST_REVERSED
    const long long t = T - 1 - k;
#else
    const long long t = k;
#endif
    lr::hop_thread<I, N>(src, dst, (I)p.nvec, (I)p.items, (I)t, (I)T);
  }
}

extern "C" long long host_ring_hop(const void* src, void* dst, long long n) {
  if (n <= 0) return 0;
  const lr::Plan p = lr::plan(src, dst, n);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  if (p.one_block)
    host_hop<int, 1>(s, d, p);
  else if (p.narrow)
    host_hop<int, lr::ITEMS>(s, d, p);
  else
    host_hop<long long, lr::ITEMS>(s, d, p);
  return p.nvec;
}
