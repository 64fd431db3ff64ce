// Per-row Fq2 / Fq6 products of the XLA-graph path's one-thread tower
// kernels, tower_fq2_sqr and tower_fq6_mul: the integer algorithm of
// lodestar_tpu/ops/pallas_tower.py (tower_fq2_mul and tower_fq12_mul run
// the same steps cooperatively, tower_coop.cuh).
//
// Every value here is semi-strict (digits <= 256) in and out.  The Pallas
// helpers map onto field.cuh's steps one to one, with the same carry passes
// and fold widths:
//   k_fp_mul  (schoolbook, _fold50 at bound 22: 101 columns, 3 passes) = lf::mul<16>
//   k_fp_add  (_fold50 at bound 10: 51 columns, 2 passes)             = lf::add
//   k_fp_sub  (SUBPAD, _fold50 at bound 13: 51 columns, 2 passes)     = lf::sub
// and _fold50's closing _carry(y, 23) runs the same 3 passes over the same
// 52 columns as fold's carry at bound 22.  What differs from the fused
// kernels is the Karatsuba: every add and subtract is folded on its own.
//
// The heavy steps (the Fq2 product, the Fq6 product) are real calls, as in
// field.cuh, so no kernel is one 255-register inlined body.

#pragma once

#include "field.cuh"

namespace lf {

// k_fq2_mul: Karatsuba with folded sums.
LF_CALL void tw_fq2_mul(const fq2 a, const fq2 b, fq2 out, const int* K) {
  int t0[NL], t1[NL], t2[NL], sa[NL], sb[NL];
  mul<16>(a[0], b[0], t0, K);
  mul<16>(a[1], b[1], t1, K);
  add(a[0], a[1], sa, K);
  add(b[0], b[1], sb, K);
  mul<16>(sa, sb, t2, K);
  sub(t0, t1, out[0], K);
  add(t0, t1, sa, K);
  sub(t2, sa, out[1], K);
}

// _fq2_sqr_kernel: (a0 + a1)(a0 - a1) + 2 a0 a1 u.
LF_CALL void tw_fq2_sqr(const fq2 a, fq2 out, const int* K) {
  int s[NL], d[NL], m[NL];
  add(a[0], a[1], s, K);
  sub(a[0], a[1], d, K);
  mul<16>(s, d, out[0], K);
  mul<16>(a[0], a[1], m, K);
  add(m, m, out[1], K);
}

// k_fq2_mul_by_xi: (1 + u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u.
LF_HD void tw_mul_by_xi(const fq2 a, fq2 out, const int* K) {
  sub(a[0], a[1], out[0], K);
  add(a[0], a[1], out[1], K);
}

// k_fq6_mul: Toom-style, six Karatsubas and the xi recombination.
LF_CALL void tw_fq6_mul(const fq2* A, const fq2* B, fq2* C, const int* K) {
  fq2 t[6], sa, sb, u, v;
  tw_fq2_mul(A[0], B[0], t[0], K);
  tw_fq2_mul(A[1], B[1], t[1], K);
  tw_fq2_mul(A[2], B[2], t[2], K);
  const int pairs[3][2] = {{1, 2}, {0, 1}, {0, 2}};
  for (int k = 0; k < 3; ++k) {
    fq2_add(A[pairs[k][0]], A[pairs[k][1]], sa, K);
    fq2_add(B[pairs[k][0]], B[pairs[k][1]], sb, K);
    tw_fq2_mul(sa, sb, t[3 + k], K);
  }
  // c0 = t0 + xi (t3 - (t1 + t2))
  fq2_add(t[1], t[2], u, K);
  fq2_sub(t[3], u, v, K);
  tw_mul_by_xi(v, u, K);
  fq2_add(t[0], u, C[0], K);
  // c1 = (t4 - (t0 + t1)) + xi t2
  fq2_add(t[0], t[1], u, K);
  fq2_sub(t[4], u, v, K);
  tw_mul_by_xi(t[2], u, K);
  fq2_add(v, u, C[1], K);
  // c2 = (t5 - (t0 + t2)) + t1
  fq2_add(t[0], t[2], u, K);
  fq2_sub(t[5], u, v, K);
  fq2_add(v, t[1], C[2], K);
}

// -- the two one-thread row bodies ---------------------------------------------
// in[i] / out[0] point at (N, K, 2, 50) float32 arrays of semi-strict
// digits, K = 1 or 3 Fq2 components; each body computes one row.

template <int KC>
LF_HD void load_fq2s(const float* p, fq2* x) {
  for (int k = 0; k < KC; ++k) load2(p + k * 2 * NL, x[k]);
}

template <int KC>
LF_HD void store_fq2s(float* p, const fq2* x) {
  for (int k = 0; k < KC; ++k) store2(p + k * 2 * NL, x[k]);
}

// pallas_tower._fq2_sqr_kernel
LF_HD void row_tower_fq2_sqr(const float* const* in, float* const* out, int row, const int* K) {
  fq2 a, o;
  load2(in[0] + row * 2 * NL, a);
  tw_fq2_sqr(a, o, K);
  store2(out[0] + row * 2 * NL, o);
}

// pallas_tower._fq6_mul_kernel
LF_HD void row_tower_fq6_mul(const float* const* in, float* const* out, int row, const int* K) {
  fq2 a[3], b[3], c[3];
  load_fq2s<3>(in[0] + row * 6 * NL, a);
  load_fq2s<3>(in[1] + row * 6 * NL, b);
  tw_fq6_mul(a, b, c, K);
  store_fq2s<3>(out[0] + row * 6 * NL, c);
}

}  // namespace lf
