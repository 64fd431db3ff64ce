// Per-row BLS12-381 base-field arithmetic for the fused kernels.
//
// An Fq element is 50 little-endian 8-bit digits held as int32 (the
// float32 digits of the Python side, converted on load).  "Loose" digits
// are <= 2^22 - 1; "semi-strict" digits are <= 256.  Every function here
// reproduces, digit for digit, the integer values the JAX package's
// fused_core computes (m_fold, m_mul, m_fq2_mul, m_fq2_sqr, m_add, m_sub
// and the Barrett canonicalisation of _canon_k): the same carry passes
// for the same bound, the same fold widths and the same truncations.
// All values stay below 2^24, so int32 holds them exactly, and every
// floor(x / 256) of the JAX code acts on a non-negative integer and is
// the shift x >> 8.
//
// The functions are __host__ __device__: the kernels in fused_kernels.cu
// call the row_* bodies at the bottom, and host_shim.cpp builds the very
// same bodies with g++ for the CPU parity test.

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#endif

// Small helpers are inlined; the heavy steps (fold, the digit product,
// the Fq2 product and square, the canonicalisation) are real calls.  With
// them inlined as well, every kernel sits at 255 registers and spills, and
// ptxas -O2/-O3 of CUDA 12.8 miscompiles the fq2mul, fq2sqr and ladder
// kernels (right at ptxas -O0/-O1; tests/kernel_build_variants.py).
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
constexpr int K_LEN = K_P2C + NL;        // 2904

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

// Fq2 values are int[2][50] component pairs.
typedef int fq2[2][NL];

// m_fq2_mul: Karatsuba, three Fq products.
LF_CALL void fq2_mul(const fq2 a, const fq2 b, fq2 out, const int* K) {
  int t0[NL], t1[NL], t2[NL], sa[NL], sb[NL], u[NL];
  mul<16>(a[0], b[0], t0, K);
  mul<16>(a[1], b[1], t1, K);
  for (int j = 0; j < NL; ++j) {
    sa[j] = a[0][j] + a[1][j];
    sb[j] = b[0][j] + b[1][j];
  }
  mul<18>(sa, sb, t2, K);
  sub(t0, t1, out[0], K);
  for (int j = 0; j < NL; ++j) u[j] = t2[j] + (K[K_PAD + j] - (t0[j] + t1[j]));
  fold<NL, 13>(u, out[1], K);
}

// m_fq2_sqr: (a0 + a1)(a0 - a1) + 2 a0 a1 u.
LF_CALL void fq2_sqr(const fq2 a, fq2 out, const int* K) {
  int d[NL], s[NL], m[NL];
  sub(a[0], a[1], d, K);
  for (int j = 0; j < NL; ++j) s[j] = a[0][j] + a[1][j];
  mul<17>(s, d, out[0], K);
  mul<16>(a[0], a[1], m, K);
  scale<10>(m, 2, out[1], K);
}

LF_HD void fq2_add(const fq2 a, const fq2 b, fq2 out, const int* K) {
  add(a[0], b[0], out[0], K);
  add(a[1], b[1], out[1], K);
}

LF_HD void fq2_sub(const fq2 a, const fq2 b, fq2 out, const int* K) {
  sub(a[0], b[0], out[0], K);
  sub(a[1], b[1], out[1], K);
}

template <int BITS>
LF_HD void fq2_scale(const fq2 a, int k, fq2 out, const int* K) {
  scale<BITS>(a[0], k, out[0], K);
  scale<BITS>(a[1], k, out[1], K);
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

LF_HD void load2(const float* p, fq2 x) {
  load(p, x[0]);
  load(p + NL, x[1]);
}

LF_HD void load2_fold(const float* p, fq2 x, const int* K) {
  load_fold(p, x[0], K);
  load_fold(p + NL, x[1], K);
}

LF_HD void store2(float* p, const fq2 x) {
  store(p, x[0]);
  store(p + NL, x[1]);
}

// -- canonical reduction ----------------------------------------------------

// _k_ripple: exact serial carry over W output digits of a WIN-digit input;
// the final carry is dropped.
template <int WIN, int W>
LF_HD void ripple(const int* x, int* out) {
  int carry = 0;
  for (int i = 0; i < W; ++i) {
    const int t = (i < WIN ? x[i] : 0) + carry;
    out[i] = t & 255;
    carry = t >> 8;
  }
}

// _k_cond_sub: r - c if r >= c else r, for strict r and a constant c.
LF_CALL void cond_sub(int* r, const int* c) {
  int t[NL], s[NL + 1];
  for (int k = 0; k < NL; ++k) t[k] = r[k] + (255 - c[k]) + (k == 0);
  ripple<NL, NL + 1>(t, s);
  if (s[NL] == 1)
    for (int k = 0; k < NL; ++k) r[k] = s[k];
}

// _canon_k: loose digits -> the canonical residue < p, strict digits.
// Fold, ripple to 51 digits, Barrett quotient from the top 4 digits with
// mu = floor(2^424 / p), subtract q*p, then two conditional subtractions.
LF_CALL void canon(const int* xin, int* out, const int* K) {
  int f[NL], x[NL + 1];
  fold<NL, 22>(xin, f, K);
  ripple<NL, NL + 1>(f, x);
  int z[11], zr[12];
  for (int k = 0; k < 11; ++k) z[k] = 0;
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 6; ++k) z[i + k] += x[47 + i] * K[K_MU + k];
  ripple<11, 12>(z, zr);
  int qp[NL + 1], qr[NL + 1];
  for (int k = 0; k < NL + 1; ++k) qp[k] = 0;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 48; ++k) qp[i + k] += zr[6 + i] * K[K_P48 + k];
  ripple<NL + 1, NL + 1>(qp, qr);
  int d[NL + 1], r[NL + 1];
  for (int k = 0; k < NL + 1; ++k) d[k] = x[k] + (255 - qr[k]) + (k == 0);
  ripple<NL + 1, NL + 1>(d, r);
  cond_sub(r, K + K_P2C);
  cond_sub(r, K + K_PC);
  for (int k = 0; k < NL; ++k) out[k] = r[k];
}

// -- the ten row bodies -------------------------------------------------------
// in[i] / out[i] point at (N, 50) or (N, 2, 50) float32 arrays; each body
// computes one row.

// fused_core._mul_k
LF_HD void row_mul(const float* const* in, float* const* out, int row, const int* K) {
  int a[NL], b[NL], o[NL];
  load_fold(in[0] + row * NL, a, K);
  load_fold(in[1] + row * NL, b, K);
  mul<16>(a, b, o, K);
  store(out[0] + row * NL, o);
}

// fused_core._fq2mul_k
LF_HD void row_fq2mul(const float* const* in, float* const* out, int row, const int* K) {
  fq2 a, b, o;
  load2_fold(in[0] + row * 2 * NL, a, K);
  load2_fold(in[1] + row * 2 * NL, b, K);
  fq2_mul(a, b, o, K);
  store2(out[0] + row * 2 * NL, o);
}

// fused_core._fq2sqr_k: the square and the folded input
LF_HD void row_fq2sqr(const float* const* in, float* const* out, int row, const int* K) {
  fq2 a, o;
  load2_fold(in[0] + row * 2 * NL, a, K);
  fq2_sqr(a, o, K);
  store2(out[0] + row * 2 * NL, o);
  store2(out[1] + row * 2 * NL, a);
}

// fused_core._pow16mul_k: r^16 * t in Fq
LF_HD void row_pow16mul(const float* const* in, float* const* out, int row, const int* K) {
  int r[NL], t[NL], s[NL];
  load_fold(in[0] + row * NL, r, K);
  load_fold(in[1] + row * NL, t, K);
  for (int i = 0; i < 4; ++i) {
    mul<16>(r, r, s, K);
    for (int j = 0; j < NL; ++j) r[j] = s[j];
  }
  mul<16>(r, t, s, K);
  store(out[0] + row * NL, s);
}

// fused_core._fq2pow16mul_k: r^16 * t in Fq2
LF_HD void row_fq2pow16mul(const float* const* in, float* const* out, int row, const int* K) {
  fq2 r, t, s;
  load2_fold(in[0] + row * 2 * NL, r, K);
  load2_fold(in[1] + row * 2 * NL, t, K);
  for (int i = 0; i < 4; ++i) {
    fq2_sqr(r, s, K);
    for (int c = 0; c < 2; ++c)
      for (int j = 0; j < NL; ++j) r[c][j] = s[c][j];
  }
  fq2_mul(r, t, s, K);
  store2(out[0] + row * 2 * NL, s);
}

// fused_core._fold_k
LF_HD void row_fold(const float* const* in, float* const* out, int row, const int* K) {
  int x[NL];
  load_fold(in[0] + row * NL, x, K);
  store(out[0] + row * NL, x);
}

// fused_core._canon_k
LF_HD void row_canon(const float* const* in, float* const* out, int row, const int* K) {
  int x[NL], o[NL];
  load(in[0] + row * NL, x);
  canon(x, o, K);
  store(out[0] + row * NL, o);
}

// fused_ladder._lad1_k. in: x1 y1 z1 x2 y2 z2 (loose);
// out: z1z1 z2z2 a1 bb1 yz1 a2 bb2 yz2
LF_HD void row_lad1(const float* const* in, float* const* out, int row, const int* K) {
  const int o = row * 2 * NL;
  fq2 x1, y1, z1, r;
  load2_fold(in[2] + o, z1, K);
  fq2_sqr(z1, r, K);
  store2(out[0] + o, r);
  {
    fq2 z2;
    load2_fold(in[5] + o, z2, K);
    fq2_sqr(z2, r, K);
    store2(out[1] + o, r);
  }
  load2_fold(in[0] + o, x1, K);
  load2_fold(in[1] + o, y1, K);
  fq2_sqr(x1, r, K);
  store2(out[2] + o, r);
  fq2_sqr(y1, r, K);
  store2(out[3] + o, r);
  fq2_mul(y1, z1, r, K);
  store2(out[4] + o, r);
  fq2 x2, y2, z2;
  load2_fold(in[3] + o, x2, K);
  load2_fold(in[4] + o, y2, K);
  load2_fold(in[5] + o, z2, K);
  fq2_sqr(x2, r, K);
  store2(out[5] + o, r);
  fq2_sqr(y2, r, K);
  store2(out[6] + o, r);
  fq2_mul(y2, z2, r, K);
  store2(out[7] + o, r);
}

// fused_ladder._lad2_k. in: x1 y1 x2 y2 (loose) z1z1 z2z2 a1 bb1 a2 bb2
// (semi-strict); out: u1 u2 s1y s2y, then e x3 dmx c8 for each doubling
LF_HD void row_lad2(const float* const* in, float* const* out, int row, const int* K) {
  const int o = row * 2 * NL;
  fq2 x1, y1, x2, y2, z1z1, z2z2, r;
  load2_fold(in[0] + o, x1, K);
  load2_fold(in[1] + o, y1, K);
  load2_fold(in[2] + o, x2, K);
  load2_fold(in[3] + o, y2, K);
  load2(in[4] + o, z1z1);
  load2(in[5] + o, z2z2);
  fq2_mul(x1, z2z2, r, K);
  store2(out[0] + o, r);
  fq2_mul(x2, z1z1, r, K);
  store2(out[1] + o, r);
  fq2_mul(y1, z2z2, r, K);
  store2(out[2] + o, r);
  fq2_mul(y2, z1z1, r, K);
  store2(out[3] + o, r);
  for (int d = 0; d < 2; ++d) {
    fq2 a, bb, e, xbb, xbb2, cc, f, ac, dh, dd, d2, x3, dmx, c8;
    load2(in[6 + 2 * d] + o, a);
    load2(in[7 + 2 * d] + o, bb);
    fq2_scale<10>(a, 3, e, K);
    fq2_add(d == 0 ? x1 : x2, bb, xbb, K);
    fq2_sqr(xbb, xbb2, K);
    fq2_sqr(bb, cc, K);
    fq2_sqr(e, f, K);
    fq2_add(a, cc, ac, K);
    fq2_sub(xbb2, ac, dh, K);
    fq2_scale<10>(dh, 2, dd, K);
    fq2_scale<10>(dd, 2, d2, K);
    fq2_sub(f, d2, x3, K);
    fq2_sub(dd, x3, dmx, K);
    fq2_scale<12>(cc, 8, c8, K);
    store2(out[4 + 4 * d] + o, e);
    store2(out[5 + 4 * d] + o, x3);
    store2(out[6 + 4 * d] + o, dmx);
    store2(out[7 + 4 * d] + o, c8);
  }
}

// fused_ladder._lad3_k. in: z1 z2 (loose) u1 u2 s1y s2y z1z1 z2z2, then
// e dmx c8 yz for each doubling (semi-strict);
// out: x3 y3 z3 h sd y3d1 z3d1 y3d2 z3d2
LF_HD void row_lad3(const float* const* in, float* const* out, int row, const int* K) {
  const int o = row * 2 * NL;
  fq2 z1, z2, u1, t, s1f, s2f, h, sd, rr, hh, i2, r2, j, v, x3;
  load2_fold(in[0] + o, z1, K);
  load2_fold(in[1] + o, z2, K);
  load2(in[2] + o, u1);
  load2(in[4] + o, t);
  fq2_mul(t, z2, s1f, K);
  load2(in[5] + o, t);
  fq2_mul(t, z1, s2f, K);
  load2(in[3] + o, t);
  fq2_sub(t, u1, h, K);
  fq2_sub(s2f, s1f, sd, K);
  fq2_scale<10>(sd, 2, rr, K);
  fq2_scale<10>(h, 2, hh, K);
  fq2_sqr(hh, i2, K);
  fq2_sqr(rr, r2, K);
  fq2_mul(h, i2, j, K);
  fq2_mul(u1, i2, v, K);
  {
    fq2 jv2;
    for (int c = 0; c < 2; ++c) {
      int s[NL];
      for (int k = 0; k < NL; ++k) s[k] = j[c][k] + v[c][k] + v[c][k];
      fold<NL, 10>(s, jv2[c], K);
    }
    fq2_sub(r2, jv2, x3, K);
  }
  {
    fq2 vmx, rvx, s1j, s1j2, y3;
    fq2_sub(v, x3, vmx, K);
    fq2_mul(rr, vmx, rvx, K);
    fq2_mul(s1f, j, s1j, K);
    fq2_scale<10>(s1j, 2, s1j2, K);
    fq2_sub(rvx, s1j2, y3, K);
    store2(out[1] + o, y3);
  }
  {
    fq2 zsum, zsum2, zz, z1z1, z2z2, zd, z3;
    fq2_add(z1, z2, zsum, K);
    fq2_sqr(zsum, zsum2, K);
    load2(in[6] + o, z1z1);
    load2(in[7] + o, z2z2);
    fq2_add(z1z1, z2z2, zz, K);
    fq2_sub(zsum2, zz, zd, K);
    fq2_mul(zd, h, z3, K);
    store2(out[2] + o, z3);
  }
  store2(out[0] + o, x3);
  store2(out[3] + o, h);
  store2(out[4] + o, sd);
  for (int d = 0; d < 2; ++d) {
    fq2 e, dmx, ed, c8, y3d, yz, z3d;
    load2(in[8 + 4 * d] + o, e);
    load2(in[9 + 4 * d] + o, dmx);
    fq2_mul(e, dmx, ed, K);
    load2(in[10 + 4 * d] + o, c8);
    fq2_sub(ed, c8, y3d, K);
    store2(out[5 + 2 * d] + o, y3d);
    load2(in[11 + 4 * d] + o, yz);
    fq2_scale<10>(yz, 2, z3d, K);
    store2(out[6 + 2 * d] + o, z3d);
  }
}

}  // namespace lf
