// Per-row BLS12-381 base-field arithmetic for the fused kernels.
//
// An Fq element is 50 little-endian 8-bit digits held as int32 (the
// float32 digits of the Python side, converted on load).  "Loose" digits
// are <= 2^22 - 1; "semi-strict" digits are <= 256.  Every function here
// reproduces, digit for digit, the integer values the JAX package's
// fused_core computes (m_fold, m_mul, m_add, m_sub): the same carry
// passes for the same bound, the same fold widths and the same
// truncations.
// All values stay below 2^24, so int32 holds them exactly, and every
// floor(x / 256) of the JAX code acts on a non-negative integer and is
// the shift x >> 8.
//
// The functions are __host__ __device__: the fold kernel in
// fused_kernels.cu calls the row body at the bottom, the library kernel's
// limbs.cuh takes the constant table's layout and the carry counts, and
// host_shim.cpp builds the very same bodies with g++ for the CPU parity
// test.  The other thirteen row kernels are the cooperative bodies of
// field_coop.cuh and tower_coop.cuh, whose steps mirror fold, mul, add,
// sub and scale here (m_fq2_mul, m_fq2_sqr, the tower products and canon's
// Barrett reduction in stages).

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#endif

// Small helpers are inlined; the heavy steps (fold, the digit product)
// are real calls.  With them inlined as well, every kernel sits at 255 registers and spills, and ptxas -O2/-O3 of CUDA 12.8
// miscompiled the one-thread fq2mul, fq2sqr and ladder kernels (right at
// ptxas -O0/-O1; tests/kernel_build_variants.py).
#define LF_HD static __host__ __device__ __forceinline__
#ifdef LF_INLINE_ALL  // every step inlined: the miscompiled layout
#define LF_CALL LF_HD
#else
#define LF_CALL static __host__ __device__ __noinline__
#endif

namespace lf {

constexpr int NL = 50;

// Layout of the int32 constant table the wrapper hands every kernel
// (built from the Python constants as fused_core._CONST_TABLE).
constexpr int K_RED = 0;                 // 54 x 50 fold rows: 2^(8(49+k)) mod p
constexpr int K_PAD = K_RED + 54 * NL;   // 50: bias-2^12 subtraction pad
constexpr int K_MU = K_PAD + NL;         // 6: floor(2^424 / p)
constexpr int K_P48 = K_MU + 6;          // 48: p
constexpr int K_PC = K_P48 + 48;         // 50: p
constexpr int K_P2C = K_PC + NL;         // 50: 2p
constexpr int K_PAD51 = K_P2C + NL;      // 51: limbs.fp_sub's pad (limbs.cuh)
constexpr int K_LEN = K_PAD51 + NL + 1;  // 2955

// _m_carry's headroom columns and pass count for a digit bound of
// 2^bits - 1 (the JAX while-loop, evaluated at compile time).
constexpr int carry_extra(int bits) {
  return (bits - 8 + 7) / 8 > 1 ? (bits - 8 + 7) / 8 : 1;
}
constexpr int carry_passes(int bits) {
  long long b = (1LL << bits) - 1;
  int n = 0;
  while (b > 256) {
    b = 255 + b / 256;
    ++n;
  }
  return n;
}

// One value-preserving carry pass: digit i becomes lo(x_i) + hi(x_{i-1});
// the top digit's carry is dropped, as the JAX shift drops it.
template <int W>
LF_HD void carry_pass(int* x) {
  for (int i = W - 1; i > 0; --i) x[i] = (x[i] & 255) + (x[i - 1] >> 8);
  x[0] &= 255;
}

// m_fold: W loose digits (bound 2^BITS - 1) -> 50 semi-strict digits.
// Carry, fold digits 49.. through the RED rows, carry at bound 22.
template <int W, int BITS>
LF_CALL void fold(const int* xin, int* out, const int* K) {
  constexpr int W2 = W + carry_extra(BITS);
  constexpr int PASSES = carry_passes(BITS);
  constexpr int PASSES_OUT = carry_passes(22);
  static_assert(W2 <= 102, "fold input wider than the RED table");
  int x[W2];
  for (int i = 0; i < W; ++i) x[i] = xin[i];
  for (int i = W; i < W2; ++i) x[i] = 0;
  for (int p = 0; p < PASSES; ++p) carry_pass<W2>(x);
  int y[NL + 2];
  for (int j = 0; j < NL - 1; ++j) y[j] = x[j];
  y[NL - 1] = y[NL] = y[NL + 1] = 0;
  for (int r = 0; r < W2 - (NL - 1); ++r) {
    const int h = x[NL - 1 + r];
    const int* red = K + K_RED + r * NL;
    for (int j = 0; j < NL; ++j) y[j] += h * red[j];
  }
  for (int p = 0; p < PASSES_OUT; ++p) carry_pass<NL + 2>(y);
  for (int j = 0; j < NL; ++j) out[j] = y[j];
}

// m_mul: a * b mod p for digits with a_i * b_j <= 2^BITS (BITS <= 18:
// the 99 anti-diagonal sums stay below 50 * 2^18 < 2^24).
template <int BITS>
LF_CALL void mul(const int* a, const int* b, int* out, const int* K) {
  static_assert(BITS <= 18, "anti-diagonal sums would leave the exact range");
  int acc[2 * NL - 1];
  for (int k = 0; k < 2 * NL - 1; ++k) acc[k] = 0;
  for (int i = 0; i < NL; ++i) {
    const int ai = a[i];
    for (int j = 0; j < NL; ++j) acc[i + j] += ai * b[j];
  }
  fold<2 * NL - 1, (BITS + 6 < 24 ? BITS + 6 : 24)>(acc, out, K);
}

// m_add: ss + ss -> ss.
LF_HD void add(const int* a, const int* b, int* out, const int* K) {
  int t[NL];
  for (int j = 0; j < NL; ++j) t[j] = a[j] + b[j];
  fold<NL, 10>(t, out, K);
}

// m_sub: ss - ss mod p -> ss, through the bias-2^12 pad.
LF_HD void sub(const int* a, const int* b, int* out, const int* K) {
  int t[NL];
  for (int j = 0; j < NL; ++j) t[j] = a[j] + (K[K_PAD + j] - b[j]);
  fold<NL, 13>(t, out, K);
}

// m_fold(k * a, BITS) for a small multiple k (doublings, e = 3a, 8c).
template <int BITS>
LF_HD void scale(const int* a, int k, int* out, const int* K) {
  int t[NL];
  for (int j = 0; j < NL; ++j) t[j] = k * a[j];
  fold<NL, BITS>(t, out, K);
}

// -- loads and stores of one row ------------------------------------------

LF_HD void load(const float* p, int* x) {
  for (int j = 0; j < NL; ++j) x[j] = (int)p[j];
}

LF_HD void store(float* p, const int* x) {
  for (int j = 0; j < NL; ++j) p[j] = (float)x[j];
}

// loose Fq row -> semi-strict (m_fold at the entry bound 22)
LF_HD void load_fold(const float* p, int* x, const int* K) {
  int t[NL];
  load(p, t);
  fold<NL, 22>(t, x, K);
}

// -- the one-thread row body ----------------------------------------------------
// in[0] / out[0] point at (N, 50) float32 arrays; the body computes one row.

// fused_core._fold_k
LF_HD void row_fold(const float* const* in, float* const* out, int row, const int* K) {
  int x[NL];
  load_fold(in[0] + row * NL, x, K);
  store(out[0] + row * NL, x);
}

}  // namespace lf
