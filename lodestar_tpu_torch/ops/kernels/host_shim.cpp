// Host build of the kernels' row bodies (field.cuh) with a plain C
// interface, for the CPU parity test: the same arithmetic the CUDA
// kernels run, looped over rows on the CPU.  Built with g++ by
// tests/test_torch_kernel_host.py; not part of the device path.

#include "field.cuh"

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

LF_HOST(mul)
LF_HOST(fq2mul)
LF_HOST(fq2sqr)
LF_HOST(pow16mul)
LF_HOST(fq2pow16mul)
LF_HOST(fold)
LF_HOST(canon)
LF_HOST(lad1)
LF_HOST(lad2)
LF_HOST(lad3)
