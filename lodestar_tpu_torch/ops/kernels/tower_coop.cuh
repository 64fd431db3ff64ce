// Cooperative bodies of the XLA-graph path's four tower kernels,
// tower_fq2_mul, tower_fq2_sqr, tower_fq6_mul and tower_fq12_mul:
// field_coop.cuh's machinery (one warp per Fq step, the digits across the
// lanes, every value of a row in shared memory, the stages separated by
// block syncs) on the integer algorithm of lodestar_tpu/ops/pallas_tower.py.
//
// The digits are pallas_tower's, not the fused path's.  Its Karatsuba
// folds the sums a0 + a1 and b0 + b1 before their product, and takes out1
// as t2 - fold(t0 + t1), two folds; the fused path's fq2mul_products /
// fq2mul_finish (field_coop.cuh) multiply the unfolded sums and fold
// t2 + pad - t0 - t1 once, the same value mod p in other digits.  Its Fq2
// square folds a0 + a1 before the product (s d) and doubles a0 a1 with a
// fold of m + m; the fused fq2sqr_finish multiplies the unfolded sum.
// Every Fq6 and Fq12 add and subtract, mul_by_xi's too, is a fold of its
// own.  Each step is the twin of a step of the plain versions
// (ops/tower_kernels.py: k_fp_mul = mul, k_fp_add = fold<10> of add,
// k_fp_sub = fold<13> of sub), so the block bodies equal them digit for
// digit.

#pragma once

#include "field_coop.cuh"

// warps a row and rows a block (other counts only for the card tests'
// variants)
#ifndef LF_TOWER_FQ12_WARPS
#define LF_TOWER_FQ12_WARPS 16  // tower_fq12_mul: warps, one row a block
#endif
#ifndef LF_TOWER_FQ12_BLOCKS_PER_SM
#define LF_TOWER_FQ12_BLOCKS_PER_SM 1  // tower_fq12_mul: blocks a SM its registers are sized for
#endif
#ifndef LF_TOWER_FQ2_WARPS
#define LF_TOWER_FQ2_WARPS 3  // tower_fq2_mul: warps a row
#endif
#ifndef LF_TOWER_FQ2_ROWS
#define LF_TOWER_FQ2_ROWS 2  // tower_fq2_mul: rows a block
#endif
#ifndef LF_TOWER_FQ2SQR_WARPS
#define LF_TOWER_FQ2SQR_WARPS 3  // tower_fq2_sqr: warps a row
#endif
#ifndef LF_TOWER_FQ2SQR_ROWS
#define LF_TOWER_FQ2SQR_ROWS 2  // tower_fq2_sqr: rows a block
#endif
#ifndef LF_TOWER_FQ6_WARPS
#define LF_TOWER_FQ6_WARPS 12  // tower_fq6_mul: warps, one row a block
#endif

namespace lfc {

constexpr int TOWER_FQ12_WARPS = LF_TOWER_FQ12_WARPS;
constexpr int TOWER_FQ2_WARPS = LF_TOWER_FQ2_WARPS;
constexpr int TOWER_FQ2_ROWS = LF_TOWER_FQ2_ROWS;
constexpr int TOWER_FQ2SQR_WARPS = LF_TOWER_FQ2SQR_WARPS;
constexpr int TOWER_FQ2SQR_ROWS = LF_TOWER_FQ2SQR_ROWS;
constexpr int TOWER_FQ6_WARPS = LF_TOWER_FQ6_WARPS;

// pallas_tower.k_fq2_mul in three stages, stage = 0, 1, 2, through t (t0
// t1 t2) and s (sa sb, then t0 + t1), 3 x 50 each (S = Fq step):
//   0: t0 = a0 b0, t1 = a1 b1 (products); sa = a0 + a1, sb = b0 + b1   2 mul + 2 S
//   1: t2 = sa sb (product); out0 = t0 - t1, s = t0 + t1               1 mul + 2 S
//   2: out1 = t2 - s                                                   1 S
template <int NW>
LC_HD void tw_karatsuba(Ctx<NW>& c, int stage, const int* a, const int* b, int* t, int* s,
                        int* out) {
  if (stage == 0) {
    t_mul(c, a, nullptr, b, nullptr, t);
    t_mul(c, a + NL, nullptr, b + NL, nullptr, t + NL);
    t_fold<10>(c, add(a, a + NL), s);
    t_fold<10>(c, add(b, b + NL), s + NL);
  } else if (stage == 1) {
    t_mul(c, s, nullptr, s + NL, nullptr, t + 2 * NL);
    t_fold<13>(c, sub(t, t + NL), out);
    t_fold<10>(c, add(t, t + NL), s + 2 * NL);
  } else {
    t_fold<13>(c, sub(t + 2 * NL, s + 2 * NL), out + NL);
  }
}

// k_fq2_mul_by_xi: (1 + u)(a0 + a1 u) = (a0 - a1) + (a0 + a1) u, 2 S
template <int NW>
LC_HD void tw_xi(Ctx<NW>& c, const int* a, int* out) {
  t_fold<13>(c, sub(a, a + NL), out);
  t_fold<10>(c, add(a, a + NL), out + NL);
}

// -- pallas_tower._fq2_mul_kernel -----------------------------------------------

// in: a b (semi-strict); out: a b in Fq2
template <int NW>
struct TowerFq2Mul {
  int in[2][F2];
  int out[F2];
  int t[3 * NL];  // the products t0 t1 t2
  int s[3 * NL];  // the folded sums sa sb, then t0 + t1
  int scr[NW * SCR];
};

// The schedule: tw_karatsuba's three stages (at most 2 products and 2
// folds at once).
template <int NW>
struct TowerFq2MulStages {
  TowerFq2Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    TowerFq2Mul<NW>& r = *s;
    tw_karatsuba(c, st, r.in[0], r.in[1], r.t, r.s, r.out);
  }
};

template <int NW, int R>
LC_HD void block_tower_fq2_mul(const float* const* in, float* const* out, int n, int block,
                               const int* K, Block<TowerFq2Mul, NW, R>& s) {
  const int* k = load_rows<F2>(in, 2, n, block, K, s);
  run_stages<TowerFq2MulStages>(s, k, 3);
  store_rows<F2>(s, 1, out, n, block);
}

// -- pallas_tower._fq2_sqr_kernel -----------------------------------------------

// in: a (semi-strict); out: a^2 in Fq2
template <int NW>
struct TowerFq2Sqr {
  int in[1][F2];
  int out[F2];
  int sd[F2];  // the folded s = a0 + a1 and d = a0 - a1
  int m[NL];   // the product a0 a1
  int scr[NW * SCR];
};

// pallas_tower.k_fq2_sqr, (a0 + a1)(a0 - a1) + 2 a0 a1 u, in two stages
// (S = Fq step; a fold reads no product of its own stage):
//   0: m = a0 a1 (product); s = a0 + a1, d = a0 - a1             1 mul + 2 S
//   1: out0 = s d (product); out1 = m + m                         1 mul + 1 S
template <int NW>
struct TowerFq2SqrStages {
  TowerFq2Sqr<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    TowerFq2Sqr<NW>& r = *s;
    const int* a = r.in[0];
    if (st == 0) {
      t_mul(c, a, nullptr, a + NL, nullptr, r.m);
      t_fold<10>(c, add(a, a + NL), r.sd);
      t_fold<13>(c, sub(a, a + NL), r.sd + NL);
    } else {
      t_mul(c, r.sd, nullptr, r.sd + NL, nullptr, r.out);
      t_fold<10>(c, add(r.m, r.m), r.out + NL);
    }
  }
};

template <int NW, int R>
LC_HD void block_tower_fq2_sqr(const float* const* in, float* const* out, int n, int block,
                               const int* K, Block<TowerFq2Sqr, NW, R>& s) {
  const int* k = load_rows<F2>(in, 1, n, block, K, s);
  run_stages<TowerFq2SqrStages>(s, k, 2);
  store_rows<F2>(s, 1, out, n, block);
}

// -- pallas_tower._fq6_mul_kernel -----------------------------------------------

// One Fq6 product's work arrays (fq6_level), shared by the Fq6 and the Fq12
// product's layouts.
struct TowerFq6 {
  int ps[2][3][F2];   // the pair sums of its a, of its b
  int kt[6][3 * NL];  // its six Karatsubas' products
  int ks[6][3 * NL];  // their folded sums
  int kr[6][F2];      // their results t0..t5
  int u[3][F2];       // t1 + t2, t0 + t1, t0 + t2
  int v[3][F2];       // t3 - u0, t4 - u1, t5 - u2
  int x[2][F2];       // xi v0, xi t2
};

// k_fq6_mul's pairs (1, 2), (0, 1), (0, 2): Karatsubas 3, 4, 5
LC_HD int pair_lo(int k) { return k == 0 ? 1 : 0; }
LC_HD int pair_hi(int k) { return k == 1 ? 1 : 2; }

// pallas_tower.k_fq6_mul, C = A B (3 Fq2 values each), at its level l,
// the stages after its operands are ready, through the work arrays w
// (S = Fq step):
//   0: Karatsubas 0-2 stage 0; the pair sums of A and of B      6 mul + 18 S
//   1: Karatsubas 0-2 stage 1, 3-5 stage 0                      9 mul + 12 S
//   2: Karatsubas 0-2 stage 2, 3-5 stage 1                      3 mul + 9 S
//   3: Karatsubas 3-5 stage 2; u0 u1 u2; x1 = xi t2             11 S
//   4: v0 v1 v2                                                 6 S
//   5: x0 = xi v0; C1 = v1 + x1, C2 = v2 + t1                   6 S
//   6: C0 = t0 + x0                                             2 S
template <int NW>
LC_HD void fq6_level(Ctx<NW>& c, TowerFq6& w, const int* A, const int* B, int* C, int l) {
  for (int k = 0; k < 6; ++k) {
    const int st = l - (k < 3 ? 0 : 1);
    if (st >= 0 && st <= 2)
      tw_karatsuba(c, st, k < 3 ? A + k * F2 : w.ps[0][k - 3], k < 3 ? B + k * F2 : w.ps[1][k - 3],
                   w.kt[k], w.ks[k], w.kr[k]);
  }
  switch (l) {
    case 0:
      for (int k = 0; k < 3; ++k) {
        add2(c, A + pair_lo(k) * F2, A + pair_hi(k) * F2, w.ps[0][k]);
        add2(c, B + pair_lo(k) * F2, B + pair_hi(k) * F2, w.ps[1][k]);
      }
      break;
    case 3:
      add2(c, w.kr[1], w.kr[2], w.u[0]);
      add2(c, w.kr[0], w.kr[1], w.u[1]);
      add2(c, w.kr[0], w.kr[2], w.u[2]);
      tw_xi(c, w.kr[2], w.x[1]);
      break;
    case 4:
      for (int k = 0; k < 3; ++k) sub2(c, w.kr[3 + k], w.u[k], w.v[k]);
      break;
    case 5:
      tw_xi(c, w.v[0], w.x[0]);
      add2(c, w.v[1], w.x[1], C + F2);
      add2(c, w.v[2], w.kr[1], C + 2 * F2);
      break;
    case 6:
      add2(c, w.kr[0], w.x[0], C);
      break;
    default:
      break;
  }
}

// in: a b (semi-strict, (3, 2, 50) a row); out: a b in Fq6
template <int NW>
struct TowerFq6Mul {
  int in[2][3][F2];
  int out[3][F2];
  TowerFq6 f6;
  int scr[NW * SCR];
};

// The schedule: fq6_level's seven levels in stages 0-6; 18 products and
// 64 folds, at most 9 products at once (stage 1).
template <int NW>
struct TowerFq6MulStages {
  TowerFq6Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    TowerFq6Mul<NW>& r = *s;
    fq6_level(c, r.f6, r.in[0][0], r.in[1][0], r.out[0], st);
  }
};

template <int NW, int R>
LC_HD void block_tower_fq6_mul(const float* const* in, float* const* out, int n, int block,
                               const int* K, Block<TowerFq6Mul, NW, R>& s) {
  const int* k = load_rows<3 * F2>(in, 2, n, block, K, s);
  run_stages<TowerFq6MulStages>(s, k, 7);
  store_rows<3 * F2>(s, 1, out, n, block);
}

// -- pallas_tower._fq12_mul_kernel ----------------------------------------------

// in: a b (semi-strict, flat [c00 c01 c02 c10 c11 c12]); out: a b in Fq12.
// Fq6 product p = 0, 1, 2 is T0 = a0 b0, T1 = a1 b1, T3 = (a0 + a1)(b0 + b1).
template <int NW>
struct TowerFq12Mul {
  int in[2][6][F2];
  int out[6][F2];
  int s12[2][3][F2];  // a0 + a1, b0 + b1: the operands of T3
  TowerFq6 f6[3];     // the Fq6 products' work arrays
  int t6[3][3][F2];   // the Fq6 products T0 T1 T3
  int w[4][F2];       // xi T1[2], then T0[j] + T1[j]
  int scr[NW * SCR];
};

// The schedule: T0 and T1 at their levels 0-6 in stages 0-6, T3 (whose
// operands stage 0 sums) one stage behind, interleaved with them, then
// C0 = T0 + v T1, C1 = T3 - (T0 + T1); 54 products and 224 folds in 9
// stages (S = Fq step):
//   0: a0 + a1, b0 + b1; T0, T1 level 0                         12 mul + 48 S
//   1: T0, T1 level 1; T3 level 0                               24 mul + 42 S
//   2: T0, T1 level 2; T3 level 1                               15 mul + 30 S
//   3: T0, T1 level 3; T3 level 2                               3 mul + 31 S
//   4: T0, T1 level 4; T3 level 3                               23 S
//   5: T0, T1 level 5; T3 level 4                               18 S
//   6: T0, T1 level 6; T3 level 5; w0 = xi T1[2]; out2 = T0[2] + T1[1];
//      w2 = T0[1] + T1[1], w3 = T0[2] + T1[2]                   18 S
//   7: T3 level 6; out0 = T0[0] + w0, out1 = T0[1] + T1[0];
//      w1 = T0[0] + T1[0]; out4 = T3[1] - w2, out5 = T3[2] - w3  12 S
//   8: out3 = T3[0] - w1                                        2 S
template <int NW>
struct TowerFq12MulStages {
  TowerFq12Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    TowerFq12Mul<NW>& r = *s;
    if (st == 0)
      for (int j = 0; j < 3; ++j) {
        add2(c, r.in[0][j], r.in[0][3 + j], r.s12[0][j]);
        add2(c, r.in[1][j], r.in[1][3 + j], r.s12[1][j]);
      }
    if (st <= 6) {
      fq6_level(c, r.f6[0], r.in[0][0], r.in[1][0], r.t6[0][0], st);
      fq6_level(c, r.f6[1], r.in[0][3], r.in[1][3], r.t6[1][0], st);
    }
    if (st >= 1 && st <= 7) fq6_level(c, r.f6[2], r.s12[0][0], r.s12[1][0], r.t6[2][0], st - 1);
    int(*t0)[F2] = r.t6[0];
    int(*t1)[F2] = r.t6[1];
    int(*t3)[F2] = r.t6[2];
    if (st == 6) {
      tw_xi(c, t1[2], r.w[0]);
      add2(c, t0[2], t1[1], r.out[2]);
      add2(c, t0[1], t1[1], r.w[2]);
      add2(c, t0[2], t1[2], r.w[3]);
    } else if (st == 7) {
      add2(c, t0[0], r.w[0], r.out[0]);
      add2(c, t0[1], t1[0], r.out[1]);
      add2(c, t0[0], t1[0], r.w[1]);
      sub2(c, t3[1], r.w[2], r.out[4]);
      sub2(c, t3[2], r.w[3], r.out[5]);
    } else if (st == 8) {
      sub2(c, t3[0], r.w[1], r.out[3]);
    }
  }
};

template <int NW, int R>
LC_HD void block_tower_fq12_mul(const float* const* in, float* const* out, int n, int block,
                                const int* K, Block<TowerFq12Mul, NW, R>& s) {
  const int* k = load_rows<6 * F2>(in, 2, n, block, K, s);
  run_stages<TowerFq12MulStages>(s, k, 9);
  store_rows<6 * F2>(s, 1, out, n, block);
}

// -- the kernels' blocks (warps a row, rows a block) ----------------------------

using TowerFq2MulBlock = Block<TowerFq2Mul, TOWER_FQ2_WARPS, TOWER_FQ2_ROWS>;
// tower_fq2_sqr: a warp for each step of its first stage, 2 rows a block
// (7.9 us at its path's 256 rows on the H100, 8.9 at 2 warps a row; PERF.md)
using TowerFq2SqrBlock = Block<TowerFq2Sqr, TOWER_FQ2SQR_WARPS, TOWER_FQ2SQR_ROWS>;
// tower_fq6_mul's registers sized for one block a SM, as tower_fq12_mul's:
// its path launches it at one row (12 warps: 29.2 us on the H100, 32.8 at
// 9, one product a warp in the widest stage; PERF.md)
struct TowerFq6MulBlock : Block<TowerFq6Mul, TOWER_FQ6_WARPS, 1> {
  static constexpr int MIN_BLOCKS = 1;
};
// tower_fq12_mul's registers sized for one block a SM (128 a thread at 16
// warps): its path's 129 rows are one wave at that, and at 64 registers
// (two blocks a SM) ptxas spilled 184 bytes and the kernel ran 19 %
// slower on the H100 (PERF.md)
struct TowerFq12MulBlock : Block<TowerFq12Mul, TOWER_FQ12_WARPS, 1> {
  static constexpr int MIN_BLOCKS = LF_TOWER_FQ12_BLOCKS_PER_SM;
};

}  // namespace lfc
