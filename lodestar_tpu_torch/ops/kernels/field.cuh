// The digit format, the constant table's layout and the carry counts that
// every row kernel shares (field_coop.cuh, tower_coop.cuh).
//
// An Fq element is 50 little-endian 8-bit digits held as int32 (the
// float32 digits of the Python side, converted on load).  "Loose" digits
// are <= 2^22 - 1; "semi-strict" digits are <= 256.  The kernels reproduce,
// digit for digit, the integer values of their plain versions (the JAX
// package's fused_core m_fold, m_mul, m_add, m_sub and limbs fp_strict,
// fp_mul, fp_sub): the same carry passes for the same bound, the same fold
// widths and the same truncations.
// All values stay below 2^24, so int32 holds them exactly, and every
// floor(x / 256) of the JAX code acts on a non-negative integer and is
// the shift x >> 8.
//
// Built with g++ (host_shim.cpp, for the CPU parity test) the CUDA
// function attributes below are empty.

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
constexpr int K_PAD51 = K_P2C + NL;      // 51: limbs.fp_sub's pad
constexpr int K_LEN = K_PAD51 + NL + 1;  // 2955

// _m_carry's headroom columns and pass count for a digit bound of
// 2^bits - 1 (the JAX while-loop, evaluated at compile time; the limbs
// library's _extra and _passes are the same functions).
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

}  // namespace lf
