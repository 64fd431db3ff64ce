// Host build of the kernels' row bodies (field.cuh, field_coop.cuh, tower.cuh, limbs.cuh)
// with a plain C interface, for the CPU parity test: the same arithmetic
// the CUDA kernels run, looped over rows on the CPU (the cooperative
// bodies of lad1, lad2, lad3 and fq2pow16mul walk their lanes and warps in
// turn, over one host copy of their shared-memory layout, at the kernels'
// warp counts).  Built with g++ by
// tests/test_torch_kernel_host.py; not part of the device path.

#include <memory>

#include "field_coop.cuh"
#include "limbs.cuh"
#include "tower.cuh"

#define LF_HOST(NAME)                                                        \
  extern "C" int host_##NAME(void* const* ins, void* const* outs, int n,     \
                             const void* consts) {                           \
    const float* in[16] = {};                                                \
    float* out[12] = {};                                                     \
    for (int i = 0; i < 16 && ins[i]; ++i) in[i] = (const float*)ins[i];     \
    for (int i = 0; i < 12 && outs[i]; ++i) out[i] = (float*)outs[i];        \
    for (int row = 0; row < n; ++row)                                        \
      lf::row_##NAME(in, out, row, (const int*)consts);                      \
    return 0;                                                                \
  }

#define LF_HOST_COOP(NAME, LAYOUT)                                           \
  extern "C" int host_##NAME(void* const* ins, void* const* outs, int n,     \
                             const void* consts) {                           \
    const float* in[16] = {};                                                \
    float* out[12] = {};                                                     \
    for (int i = 0; i < 16 && ins[i]; ++i) in[i] = (const float*)ins[i];     \
    for (int i = 0; i < 12 && outs[i]; ++i) out[i] = (float*)outs[i];        \
    std::unique_ptr<lfc::LAYOUT> s(new lfc::LAYOUT());                       \
    for (int row = 0; row < n; ++row)                                        \
      lfc::block_##NAME(in, out, row, (const int*)consts, *s);               \
    return 0;                                                                \
  }

LF_HOST(mul)
LF_HOST(fq2mul)
LF_HOST(fq2sqr)
LF_HOST(pow16mul)
LF_HOST_COOP(fq2pow16mul, Fq2Pow16Mul<lfc::POW_WARPS>)
LF_HOST(fold)
LF_HOST(canon)
LF_HOST_COOP(lad1, Lad1<lfc::LAD_WARPS>)
LF_HOST_COOP(lad2, Lad2<lfc::LAD_WARPS>)
LF_HOST_COOP(lad3, Lad3<lfc::LAD_WARPS>)
LF_HOST(tower_fq2_mul)
LF_HOST(tower_fq2_sqr)
LF_HOST(tower_fq6_mul)
LF_HOST(tower_fq12_mul)
LF_HOST(library_fq2_mul)
