// Per-row Fq arithmetic in the JAX ``limbs`` digit algorithm, for the
// library kernel (library_kernels.cu): the digits of
// lodestar_tpu_torch/ops/limbs.py (which equal the JAX package's
// ops/limbs.py bitwise), step for step.
//
// This is not field.cuh's arithmetic, which folds every add and subtract on
// its own (the Pallas kernels' algorithm): here sums stay unfolded until a
// step normalises them, and each step runs the carry passes its input
// bound calls for (limbs._passes / limbs._extra):
//   - carry_exact at bound b: ``extra(b)`` zero headroom columns, then
//     ``passes(b)`` value-preserving passes (the top carry dropped);
//   - fold_tail: digits 49.. of a carried value folded back through the
//     RED rows into 50 digits (< 2^23), two zero headroom columns;
//   - fp_strict: carry at bound 24, fold, carry at bound 23;
//   - fp_mul: the 99 anti-diagonal sums of the schoolbook product (skew_sum)
//     and two headroom columns, carry at bound 22, fold, carry at bound 23;
//   - fp_sub: a + (pad - b) with the width-51 pad and its two headroom
//     columns, carry at bound 24, fold, carry at bound 23.
// Digits are int32 (the float32 digits of the Python side, converted on
// load); every value stays below 2^24 and non-negative, so each
// floor(x / 256) is x >> 8.  The heavy steps are real calls (LF_CALL), as
// in field.cuh: ptxas -O2/-O3 miscompile fully inlined row bodies.

#pragma once

#include "field.cuh"

namespace lf {
namespace limbs {

// limbs._passes: carry passes that take digits < 2^bits to <= 256.
constexpr int passes(int bits) {
  long long b = (1LL << bits) - 1;
  int n = 0;
  while (b > 256) {
    b = 255 + b / 256;
    ++n;
  }
  return n;
}

// limbs._extra: headroom columns that catch the top carry.
constexpr int extra(int bits) { return (bits - 8 + 7) / 8 > 1 ? (bits - 8 + 7) / 8 : 1; }

constexpr int FOLD_BASE = NL - 1;     // 49
constexpr int TAIL = NL + extra(23);  // 52: fold_tail's width
constexpr int WIDE = 2 * NL - 1 + extra(22);  // 101: the product's columns
constexpr int SUBW = NL + 1 + extra(24);      // 53: the subtraction's columns

// limbs._carry_passes: ``passes(BITS)`` passes in place over W digits.
template <int W, int BITS>
LF_HD void carry(int* x) {
  for (int p = 0; p < passes(BITS); ++p) {
    for (int i = W - 1; i > 0; --i) x[i] = (x[i] & 255) + (x[i - 1] >> 8);
    x[0] &= 255;
  }
}

// limbs._fold_tail: y (W digits <= 256, 50 < W <= 103) -> e (TAIL digits):
// the low 49 digits plus sum_k y[49 + k] * RED[k], two zero columns.
template <int W>
LF_CALL void fold_tail(const int* y, int* e, const int* K) {
  static_assert(W > NL && W - FOLD_BASE <= 54, "fold_tail width out of the RED table");
  for (int c = 0; c < TAIL; ++c) e[c] = 0;
  for (int k = 0; k < W - FOLD_BASE; ++k) {
    const int h = y[FOLD_BASE + k];
    const int* red = K + K_RED + k * NL;
    for (int c = 0; c < NL; ++c) e[c] += h * red[c];
  }
  for (int c = 0; c < FOLD_BASE; ++c) e[c] += y[c];
}

// limbs._finalize(x, BITS, padded=True): x (W columns, its headroom
// included, overwritten) -> 50 semi-strict digits.
template <int W, int BITS>
LF_CALL void finalize(int* x, int* out, const int* K) {
  carry<W, BITS>(x);
  int e[TAIL];
  fold_tail<W>(x, e, K);
  carry<TAIL, 23>(e);
  for (int c = 0; c < NL; ++c) out[c] = e[c];
}

// limbs.fp_strict of 50 digits (< 2^24): carry_exact pads extra(24)
// columns, then the same finalisation.
LF_CALL void fp_strict(const int* a, int* out, const int* K) {
  constexpr int W = NL + extra(24);
  int x[W];
  for (int c = 0; c < NL; ++c) x[c] = a[c];
  for (int c = NL; c < W; ++c) x[c] = 0;
  finalize<W, 24>(x, out, K);
}

// limbs.fp_mul of semi-strict a, b: skew_sum of the digit products (each
// <= 2^16, the sums < 2^22), two headroom columns, finalised at bound 22.
LF_CALL void fp_mul(const int* a, const int* b, int* out, const int* K) {
  int acc[WIDE];
  for (int c = 0; c < WIDE; ++c) acc[c] = 0;
  for (int r = 0; r < NL; ++r) {
    const int ar = a[r];
    for (int j = 0; j < NL; ++j) acc[r + j] += ar * b[j];
  }
  finalize<WIDE, 22>(acc, out, K);
}

// limbs.fp_sub(a, b) for 50-digit a (< 2^23) and b (< 2^12): the pad of
// width 51 (digits in [2^12, 2^12 + 2^8), a multiple of p) minus b plus a,
// in a buffer that holds the headroom of the carry at bound 24.
LF_CALL void fp_sub(const int* a, const int* b, int* out, const int* K) {
  int t[SUBW];
  const int* pad = K + K_PAD51;
  for (int c = 0; c < NL + 1; ++c) t[c] = pad[c];
  for (int c = NL + 1; c < SUBW; ++c) t[c] = 0;
  for (int c = 0; c < NL; ++c) t[c] += a[c] - b[c];
  finalize<SUBW, 24>(t, out, K);
}

}  // namespace limbs

// The JAX library's tower.fq2_mul (tower.fq2_mul_many at K = 1) on one row
// of (2, 50) semi-strict operands: the three lanes a0 b0, a1 b1 and
// strict(a0 + a1) strict(b0 + b1) through limbs.fp_mul, then
// c0 = fp_sub(t0, t1) and c1 = fp_sub(t2, t0 + t1).
// in: a b (semi-strict, (2, 50) a row); out: c (semi-strict).
LF_HD void row_library_fq2_mul(const float* const* in, float* const* out, int row,
                               const int* K) {
  const int o = row * 2 * NL;
  int a0[NL], a1[NL], b0[NL], b1[NL], s[NL], sa[NL], sb[NL];
  for (int c = 0; c < NL; ++c) {
    a0[c] = static_cast<int>(in[0][o + c]);
    a1[c] = static_cast<int>(in[0][o + NL + c]);
    b0[c] = static_cast<int>(in[1][o + c]);
    b1[c] = static_cast<int>(in[1][o + NL + c]);
  }
  for (int c = 0; c < NL; ++c) s[c] = a0[c] + a1[c];
  limbs::fp_strict(s, sa, K);
  for (int c = 0; c < NL; ++c) s[c] = b0[c] + b1[c];
  limbs::fp_strict(s, sb, K);
  int t0[NL], t1[NL], t2[NL], r[NL];
  limbs::fp_mul(a0, b0, t0, K);
  limbs::fp_mul(a1, b1, t1, K);
  limbs::fp_mul(sa, sb, t2, K);
  limbs::fp_sub(t0, t1, r, K);
  for (int c = 0; c < NL; ++c) out[0][o + c] = static_cast<float>(r[c]);
  for (int c = 0; c < NL; ++c) s[c] = t0[c] + t1[c];
  limbs::fp_sub(t2, s, r, K);
  for (int c = 0; c < NL; ++c) out[0][o + NL + c] = static_cast<float>(r[c]);
}

}  // namespace lf
