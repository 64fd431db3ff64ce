// Cooperative BLS12-381 field arithmetic for eleven row kernels: the
// fused path's ten (the G2 ladder's round kernels lad1, lad2 and lad3,
// fq2pow16mul, fq2mul, pow16mul, mul, fq2sqr, fold and canon) and the
// library kernel library_fq2_mul.  One warp per Fq step, the digits of a
// step across the warp's 32 lanes, every value of a row in shared memory;
// a row has NW warps and a block R rows.
//
// Layout.  A block (Block below) holds the constant table, staged once for
// its R rows, and R row layouts (Lad1, Lad2, Lad3, Fq2Pow16Mul, Fq2Mul,
// Pow16Mul, Mul, Fq2Sqr, Fold, Canon, LibFq2Mul): each row's inputs,
// outputs and intermediates as int32 digits, with a scratch area of 462
// ints per warp of the row.  No step keeps a digit array in local memory.
// The warp and row counts are template parameters of the layouts, of Ctx
// and of run_stages: each kernel has its own (the *Block aliases at the
// bottom), and the host build, which holds every body in one translation
// unit, walks the same counts.  The last block's missing rows (row >= n)
// load zeros, run every stage and reach every sync, and are not stored
// (canon, whose warps share no stage, runs nothing for them).
//
// One step on one warp (lane = threadIdx.x & 31):
//   - the 50x50 digit product: lane k sums the anti-diagonal columns k and
//     50 + k, i.e. a_i * b_((k - i) mod 50) for i = 0..49 into column k
//     (i <= k) or 50 + k (i > k): 50 multiply-adds per column pair, the 50
//     pairs spread over the 32 lanes;
//   - each carry pass: digit i becomes lo(x_i) + hi(x_(i-1)), read from one
//     buffer and written to another, so a lane reads its neighbour's old
//     digit from shared memory;
//   - the fold: lane j sums h_r * RED[r][j] over the folded rows r;
//   - the exact ripple (canon): carry passes down to digits <= 256, then
//     the 0/1 carries from the digit pairs' (generate, propagate) flags,
//     which every lane ORs into two masks and resolves with one addition.
// The steps are separated by __syncwarp(); a row's stages (the sets of
// independent steps, each on its own warp of the row: "the schedule"
// beside each kernel body) by __syncthreads(), which every row of the
// block reaches at the same stage.
//
// Why this equals the plain versions digit for digit.  Their carry pass
// takes every digit's low byte and its lower neighbour's high part at
// once, so a pass that reads one buffer and writes another is that pass.
// Every column sum, fold sum and carry is an integer below 2^24 (the
// bounds of field.cuh's header: products of semi-strict digits summed 50
// at a time, <= 50 * 512^2 < 2^24), so int32 sums taken in any order are
// the same integers.  Each step takes the same input, carry-pass count,
// fold width and truncation as its plain twin (fused_core's m_fold at a
// bound, m_mul, m_add, m_sub, a small multiple; limbs' fp_strict, fp_mul,
// fp_sub), and every stage runs the steps of the plain version on values
// that the earlier stages have finished.  An exact ripple's output is the
// value mod 256^W in strict digits, which are unique, so any exact ripple
// equals the serial one of fused_core._canon_k.
//
// The same source runs on the CPU (host_shim.cpp, built with g++ for the
// parity test): there LC_LANE_FOR walks every lane's index in turn, the
// block's warps (every row's) run one after the other, stage by stage, the
// blocks one after the other, and the syncs are no-ops.  That is the
// parallel run because within one step no lane reads a location that
// another lane writes, within one stage no warp reads what another warp
// writes, and no row reads another's values.  -DLC_HOST_REVERSED walks
// lanes, warps and blocks in the opposite order; the parity test builds
// both orders, so a step that broke either rule would show as a
// difference.
//
// Calls and registers.  The two heavy steps, mul and fold (one instance a
// carry bound and input width), are real calls (LC_STEP): inlined into the
// twelve stages of lad3 they made a body that ptxas held at 128 registers
// with spills, two blocks a SM, and ptxas -O2/-O3 of CUDA 12.8 miscompiled
// the first, one-thread kernels when every step was inlined
// (-DLF_INLINE_ALL inlines them for the variant builds of
// tests/kernel_build_variants.py).  The rest is inlined (LC_HD); no step
// keeps an array of its own.  ptxas sizes the registers at 64 a thread
// (Warps::MIN_BLOCKS: 1,024 threads a SM, for a block of 32 x NW x R
// threads; the shared memory admits at least that many blocks of every
// layout here, at its default counts), which ran faster on the H100 than
// the uncapped build at two or three blocks a SM.
//
// The constant table.  A block stages it (11.8 KB) into shared memory
// before its first stage; -DLF_COOP_K_GLOBAL (a variant for the card
// tests) reads it from global memory through the cache instead.  On the
// H100 staging cost a block of one row on one warp ~2.5 us (fq2mul and
// pow16mul at 256 rows, one wave), which the rows of a block share; read
// from global memory the table made the ladder kernels and fq2pow16mul
// 1-11 % slower, and mul and fq2sqr at one row of two warps a block no
// faster than staged at two rows (PERF.md).  fold reads 150 of its 2,955
// words and canon 304, both from global memory by default (StagedK below).

#pragma once

#include "field.cuh"

// warps a row and rows a block (other counts only for the card tests'
// variants)
#ifndef LF_COOP_WARPS
#define LF_COOP_WARPS 8  // lad1, lad2, lad3: warps, one row a block
#endif
#ifndef LF_POW_WARPS
#define LF_POW_WARPS 4  // fq2pow16mul: warps, one row a block
#endif
#ifndef LF_FQ2MUL_WARPS
#define LF_FQ2MUL_WARPS 3  // fq2mul: warps a row
#endif
#ifndef LF_FQ2MUL_ROWS
#define LF_FQ2MUL_ROWS 2  // fq2mul: rows a block
#endif
#ifndef LF_POW16_ROWS
#define LF_POW16_ROWS 4  // pow16mul: rows a block, one warp a row
#endif
#ifndef LF_MUL_WARPS
#define LF_MUL_WARPS 2  // mul: warps a row
#endif
#ifndef LF_MUL_ROWS
#define LF_MUL_ROWS 2  // mul: rows a block
#endif
#ifndef LF_FQ2SQR_WARPS
#define LF_FQ2SQR_WARPS 2  // fq2sqr: warps a row
#endif
#ifndef LF_FQ2SQR_ROWS
#define LF_FQ2SQR_ROWS 2  // fq2sqr: rows a block
#endif
#ifndef LF_CANON_ROWS
#define LF_CANON_ROWS 4  // canon: rows a block, one warp a row
#endif
#ifndef LF_CANON_K_STAGED
#define LF_CANON_K_STAGED 0  // canon: 1 stages its table slices, 0 reads them from global memory
#endif
#ifndef LF_FOLD_ROWS
#define LF_FOLD_ROWS 2  // fold: rows a block, one warp a row
#endif
#ifndef LF_FOLD_K_STAGED
#define LF_FOLD_K_STAGED 0  // fold: 1 stages the RED rows it reads, 0 reads them from global memory
#endif
#ifndef LF_LIB_FQ2MUL_WARPS
#define LF_LIB_FQ2MUL_WARPS 2  // library_fq2_mul: warps a row
#endif
#ifndef LF_LIB_FQ2MUL_ROWS
#define LF_LIB_FQ2MUL_ROWS 2  // library_fq2_mul: rows a block
#endif

#define LC_HD static __host__ __device__ __forceinline__
#define LC_MHD __host__ __device__ __forceinline__
#ifdef LF_INLINE_ALL  // every step inlined: the layout ptxas miscompiled
#define LC_STEP LC_HD
#else
#define LC_STEP static __host__ __device__ __noinline__
#endif

#ifdef __CUDA_ARCH__
#define LC_UNROLL _Pragma("unroll 10")  // the product's and the fold's walks
#define LC_LANE_FOR(i, n) for (int i = (int)(threadIdx.x & 31u); i < (n); i += 32)
#define LC_BLOCK_FOR(i, n) for (int i = (int)threadIdx.x; i < (n); i += (int)blockDim.x)
#define LC_SYNC_WARP() __syncwarp()
#define LC_SYNC_BLOCK() __syncthreads()
#elif defined(LC_HOST_REVERSED)
#define LC_UNROLL
#define LC_LANE_FOR(i, n) for (int i = (n) - 1; i >= 0; --i)
#define LC_BLOCK_FOR(i, n) for (int i = (n) - 1; i >= 0; --i)
#define LC_SYNC_WARP() ((void)0)
#define LC_SYNC_BLOCK() ((void)0)
#else
#define LC_UNROLL
#define LC_LANE_FOR(i, n) for (int i = 0; i < (n); ++i)
#define LC_BLOCK_FOR(i, n) for (int i = 0; i < (n); ++i)
#define LC_SYNC_WARP() ((void)0)
#define LC_SYNC_BLOCK() ((void)0)
#endif

namespace lfc {

using lf::NL;
constexpr int LAD_WARPS = LF_COOP_WARPS;
constexpr int POW_WARPS = LF_POW_WARPS;
constexpr int FQ2MUL_WARPS = LF_FQ2MUL_WARPS;
constexpr int FQ2MUL_ROWS = LF_FQ2MUL_ROWS;
constexpr int POW16_ROWS = LF_POW16_ROWS;
constexpr int MUL_WARPS = LF_MUL_WARPS;
constexpr int MUL_ROWS = LF_MUL_ROWS;
constexpr int FQ2SQR_WARPS = LF_FQ2SQR_WARPS;
constexpr int FQ2SQR_ROWS = LF_FQ2SQR_ROWS;
constexpr int CANON_ROWS = LF_CANON_ROWS;
constexpr int FOLD_ROWS = LF_FOLD_ROWS;
constexpr int LIB_FQ2MUL_WARPS = LF_LIB_FQ2MUL_WARPS;
constexpr int LIB_FQ2MUL_ROWS = LF_LIB_FQ2MUL_ROWS;
constexpr int F2 = 2 * NL;   // one Fq2 value: component 0, then component 1
#ifdef LF_COOP_K_GLOBAL
constexpr int K_STAGED = 1;  // the table is read from global memory
#else
constexpr int K_STAGED = lf::K_LEN;
#endif

// A block of R rows of NW warps each, and the blocks a SM that ptxas sizes
// the registers for (64 registers a thread).
template <int NW, int R>
struct Warps {
  static constexpr int ROWS = R;
  static constexpr int THREADS = 32 * NW * R;
  static constexpr int MIN_BLOCKS = 1024 / THREADS;
  static_assert(THREADS <= 1024, "a block is at most 1,024 threads");
};

// one warp's scratch: two carry buffers as wide as a product (101 digits,
// padded), two for the fold's 52 output columns, the first operand's sum
// and the second operand twice over (so that a lane's b_((k - i) mod 50)
// is one address, the warp's 32 reads 32 consecutive words)
constexpr int X0 = 0, X1 = 104, Y0 = 208, Y1 = 260, SA = 312, SB = 362;
constexpr int SCR = SB + 2 * NL;
// the exact ripple's buffers in the same scratch (free once the fold that
// precedes it has written its output): two for the carry passes, the
// digits after them, the digit pairs' carry flags (16-byte aligned)
constexpr int RA = X0, RB = X1, RV = Y0, RF = Y1;

// -- the 2^24 obligations --------------------------------------------------------

// The any-order argument above needs every sum a step forms below 2^24 and
// every fold input within the bound its carry passes are counted for.
// Each such place is a named obligation (lcb::Id): a static_assert below
// where its bound is a constant expression of the digit contracts, and a
// check of the host audit build (-DLC_BOUND_AUDIT, g++ only, never nvcc),
// which records the least and largest value each obligation reaches
// (LC_BOUND) while the bodies run on inputs at the contracts' extremes and
// on seeded ones; lodestar_tpu_torch/analysis/limb_interval.py holds them
// below 2^24, each fold input within 0..2^BITS - 1, and each at or below
// the interval proven for the same step of the plain version.
namespace lcb {

enum Id {
  FOLD_IN_10,    // a fold<10> input digit: add, add_twice, scale by 2 or 3
  FOLD_IN_12,    // a fold<12> input digit: scale by 8
  FOLD_IN_13,    // a fold<13> input digit: sub, sub_sum (the bias-2^12 pad)
  FOLD_IN_22,    // a fold<22> input digit: a loose kernel input
  FOLD_IN_24,    // a fold<24> input digit: the limbs strict sum and fp_sub
  CARRY_PASS,    // a digit after a carry pass
  REDUCE_SUM,    // a fold column: digit j plus sum_r h_r RED[r][j]
  MUL_OPERAND,   // a product operand digit: a or the sum a + a2
  MUL_COLUMN,    // an anti-diagonal column sum of the 50 x 50 product
  CANON_BARRETT, // a column of x[47..50] mu with its carry in
  CANON_QP,      // a column of q p
  CANON_RIPPLE,  // an exact ripple's input digit (x - q p, r - 2p, r' - p)
  COUNT
};

constexpr const char* NAMES[COUNT] = {
    "fold.input<10>", "fold.input<12>", "fold.input<13>", "fold.input<22>", "fold.input<24>",
    "carry.pass",     "reduce.sum",     "mul.operand",    "mul.column",     "canon.barrett",
    "canon.qp",       "canon.ripple"};

constexpr long long EXACT = 1LL << 24;  // int32 sums in any order, float32 digits exactly
constexpr long long SEMI = 256;         // a semi-strict digit
constexpr long long LOOSE = (1LL << 22) - 1;  // a loose kernel input digit
constexpr long long PAD_HI = (1LL << 12) + 255;  // a subtraction pad's digit (K_PAD, K_PAD51)
constexpr long long PAD_LO = 1LL << 12;

// the fold input bound of fold<BITS>: the carry pass count's contract
template <int BITS>
constexpr Id fold_input() {
  static_assert(BITS == 10 || BITS == 12 || BITS == 13 || BITS == 22 || BITS == 24,
                "a fold bound without an obligation");
  return BITS == 10 ? FOLD_IN_10 : BITS == 12 ? FOLD_IN_12 : BITS == 13 ? FOLD_IN_13
       : BITS == 22 ? FOLD_IN_22 : FOLD_IN_24;
}

// The constant obligations (the runtime ones are held by the audit build):
// fold inputs of the Lin helpers at the bounds their callers fold them at
static_assert(2 * SEMI <= (1LL << 10) - 1, "fold.input<10>: add of two semi-strict digits");
static_assert(3 * SEMI <= (1LL << 10) - 1, "fold.input<10>: add_twice, scale by 3");
static_assert(8 * SEMI <= (1LL << 12) - 1, "fold.input<12>: scale by 8");
static_assert(SEMI + PAD_HI <= (1LL << 13) - 1 && PAD_LO - 2 * SEMI >= 0,
              "fold.input<13>: a + (pad - b) and a + (pad - (b + c)), never negative");
static_assert(LOOSE <= (1LL << 22) - 1, "fold.input<22>: a loose input");
static_assert(SEMI + PAD_HI <= (1LL << 24) - 1, "fold.input<24>: the limbs sum and fp_sub");
// a carry pass keeps a digit's low byte and adds its neighbour's high part
static_assert(255 + ((1LL << 24) - 1) / 256 < EXACT, "carry.pass");
// the fold columns: at most 54 RED rows of digits <= 255 times digits <= 256
static_assert(54 * SEMI * 255 + SEMI < EXACT, "reduce.sum");
// the products: operands are semi-strict digits or sums of two
static_assert(2 * SEMI < EXACT, "mul.operand");
static_assert(NL * (2 * SEMI) * (2 * SEMI) < EXACT, "mul.column");
// canon: the Barrett columns (4 products of strict digits and a carry),
// the q p columns (3 products), the ripples' differences
static_assert(4 * 255 * 255 + (4 * 255 * 255) / 256 < (1LL << 18), "canon.barrett");
static_assert(3 * 255 * 255 < (1LL << 18), "canon.qp");
static_assert(3 * 255 * 255 <= (1LL << 18) - 1 && 255 + 255 + 1 <= (1LL << 9) - 1,
              "canon.ripple: q p's columns at bound 18, the differences at bound 9");

#ifdef LC_BOUND_AUDIT
#ifdef __CUDACC__
#error "LC_BOUND_AUDIT is the g++ host build's audit mode"
#endif
// the least and largest value each obligation reached since reset()
inline long long lo[COUNT];
inline long long hi[COUNT];
inline void reset() {
  for (int i = 0; i < COUNT; ++i) {
    lo[i] = 1LL << 62;
    hi[i] = -(1LL << 62);
  }
}
inline void note(Id id, long long v) {
  if (v < lo[id]) lo[id] = v;
  if (v > hi[id]) hi[id] = v;
}
#define LC_BOUND(ID, V) ::lfc::lcb::note(::lfc::lcb::ID, (long long)(V))
#define LC_BOUND_FOLD(BITS, V) ::lfc::lcb::note(::lfc::lcb::fold_input<BITS>(), (long long)(V))
#else
#define LC_BOUND(ID, V) ((void)0)
#define LC_BOUND_FOLD(BITS, V) ((void)0)
#endif

}  // namespace lcb

// -- one warp's steps ---------------------------------------------------------

// One carry pass src -> dst over w digits; the top carry is dropped.
LC_HD void carry(const int* src, int* dst, int w) {
  LC_LANE_FOR(i, w) {
    dst[i] = i == 0 ? (src[0] & 255) : (src[i] & 255) + (src[i - 1] >> 8);
    LC_BOUND(CARRY_PASS, dst[i]);
  }
  LC_SYNC_WARP();
}

// The fold proper on W2 carried digits x: digits 49.. through the RED
// rows into 52 columns, then the carry passes at bound 22, the last of
// which writes the 50 digits to out.
template <int W2>
LC_HD void reduce(const int* x, int* out, int* S, const int* K) {
  constexpr int PASSES_OUT = lf::carry_passes(22);
  static_assert(PASSES_OUT % 2 == 1, "the passes below alternate y0 -> y1 -> y0");
  int* y0 = S + Y0;
  int* y1 = S + Y1;
  // lane l sums columns l and l + 32 in one walk over the rows
  LC_LANE_FOR(l, 32) {
    const int j2 = l + 32;
    int y = x[l];
    int y2 = j2 < NL - 1 ? x[j2] : 0;
    LC_UNROLL
    for (int r = 0; r < W2 - (NL - 1); ++r) {
      const int h = x[NL - 1 + r];
      const int* red = K + lf::K_RED + r * NL;
      y += h * red[l];
      if (j2 < NL) y2 += h * red[j2];
    }
    LC_BOUND(REDUCE_SUM, y);
    y0[l] = y;
    if (j2 < NL + 2) {
      LC_BOUND(REDUCE_SUM, y2);
      y0[j2] = y2;
    }
  }
  LC_SYNC_WARP();
  for (int p = 0; p + 1 < PASSES_OUT; p += 2) {
    carry(y0, y1, NL + 2);
    carry(y1, y0, NL + 2);
  }
  LC_LANE_FOR(j, NL) {
    out[j] = j == 0 ? (y0[0] & 255) : (y0[j] & 255) + (y0[j - 1] >> 8);
    LC_BOUND(CARRY_PASS, out[j]);
  }
  LC_SYNC_WARP();
}

// The input of a fold: digit j < 50 is ka a_j + kb b_j + kc c_j, plus
// digit j of a subtraction pad when pad (its offset in the table: lf::K_PAD,
// fused_core's bias-2^12 pad, or lf::K_PAD51, limbs.fp_sub's width-51 pad)
// is set (a null pointer adds nothing); digit 50 of a 51-digit input is
// the pad's alone.  A subtraction a + (pad - b) is ka = 1, kb = -1: the
// same integer, every partial sum far inside int32.
struct Lin {
  const int *a, *b, *c;
  int ka, kb, kc;
  int pad;  // 0: no pad (the table's first words are RED rows)
  LC_MHD int operator()(int j, const int* K) const {
    int v = ka * a[j];
    if (b) v += kb * b[j];
    if (c) v += kc * c[j];
    return pad ? v + K[pad + j] : v;
  }
  // digit j of a W-digit input, zero above it
  template <int W>
  LC_MHD int digit(int j, const int* K) const {
    return j < NL ? (*this)(j, K) : j < W && pad ? K[pad + j] : 0;
  }
};
static_assert(lf::K_PAD > 0 && lf::K_PAD51 > 0, "a pad at offset 0 would read as none");

// m_fold at the bound 2^BITS - 1 of the W digits in(0..W-1) (W = 50, or
// 51 for the limbs subtraction); the first carry pass is taken as the
// digits are formed.
template <int BITS, int W = NL>
LC_STEP void fold(Lin in, int* out, int* S, const int* K) {
  constexpr int W2 = W + lf::carry_extra(BITS);
  constexpr int PASSES = lf::carry_passes(BITS);
  static_assert(W == NL || W == NL + 1, "a fold input is 50 digits or the limbs subtraction's 51");
  static_assert(PASSES >= 1 && W2 <= X1 - X0, "fold outside the scratch layout");
  int* a = S + X0;
  int* b = S + X1;
  LC_LANE_FOR(i, W2) {
    const int v = in.digit<W>(i, K);
    LC_BOUND_FOLD(BITS, v);
    a[i] = i == 0 ? (v & 255) : (v & 255) + (in.digit<W>(i - 1, K) >> 8);
    LC_BOUND(CARRY_PASS, a[i]);
  }
  LC_SYNC_WARP();
  for (int p = 1; p < PASSES; ++p) {
    carry(a, b, W2);
    int* t = a;
    a = b;
    b = t;
  }
  reduce<W2>(a, out, S, K);
}

// m_mul of (a + a2) and (b + b2) (a2, b2 may be null): the digit product,
// then m_fold of its 99 columns at the bound 2^(BITS + 6) - 1, which is 101
// columns and 3 passes for every BITS the kernels use (16, 17, 18), and
// limbs.fp_mul's finalisation at bound 22 too.
LC_STEP void mul(const int* a, const int* a2, const int* b, const int* b2, int* out, int* S,
                 const int* K) {
  constexpr int W2 = 2 * NL - 1 + lf::carry_extra(22);
  static_assert(lf::carry_extra(22) == lf::carry_extra(24) &&
                    lf::carry_passes(22) == 3 && lf::carry_passes(24) == 3,
                "mul<16..18> share one fold layout");
  LC_LANE_FOR(j, NL) {
    if (a2) S[SA + j] = a[j] + a2[j];
    const int bj = b2 ? b[j] + b2[j] : b[j];
    LC_BOUND(MUL_OPERAND, a2 ? S[SA + j] : a[j]);
    LC_BOUND(MUL_OPERAND, bj);
    S[SB + j] = bj;
    S[SB + NL + j] = bj;
  }
  LC_SYNC_WARP();
  if (a2) a = S + SA;
  const int* bb = S + SB + NL;  // bb[d] = b_(d mod 50) for d = -50..49
  // lane l takes the column pairs k = l and k = l + 32 (lanes 0..17) in one
  // walk over a: a_i b_((k - i) mod 50) goes to column k (i <= k) or 50 + k
  int* x = S + X0;
  LC_LANE_FOR(l, 32) {
    const int k2 = l + 32;
    int lo = 0, hi = 0, lo2 = 0, hi2 = 0;
    LC_UNROLL
    for (int i = 0; i < NL; ++i) {
      const int ai = a[i];
      const int t = ai * bb[l - i];
      if (i <= l)
        lo += t;
      else
        hi += t;
      if (k2 < NL) {
        const int t2 = ai * bb[k2 - i];
        if (i <= k2)
          lo2 += t2;
        else
          hi2 += t2;
      }
    }
    LC_BOUND(MUL_COLUMN, lo);
    LC_BOUND(MUL_COLUMN, hi);
    if (k2 < NL) {
      LC_BOUND(MUL_COLUMN, lo2);
      LC_BOUND(MUL_COLUMN, hi2);
    }
    x[l] = lo;
    x[NL + l] = hi;
    if (k2 < NL) {
      x[k2] = lo2;
      if (k2 < NL - 1) x[NL + k2] = hi2;
    }
    if (l < W2 - (2 * NL - 1)) x[2 * NL - 1 + l] = 0;  // the carry's headroom columns
  }
  LC_SYNC_WARP();
  carry(S + X0, S + X1, W2);
  carry(S + X1, S + X0, W2);
  carry(S + X0, S + X1, W2);
  reduce<W2>(S + X1, out, S, K);
}

// the inputs of the folds
LC_HD Lin raw(const int* a) { return Lin{a, nullptr, nullptr, 1, 0, 0, 0}; }
LC_HD Lin add(const int* a, const int* b) { return Lin{a, b, nullptr, 1, 1, 0, 0}; }
LC_HD Lin sub(const int* a, const int* b) { return Lin{a, b, nullptr, 1, -1, 0, lf::K_PAD}; }
LC_HD Lin sub_sum(const int* a, const int* b, const int* c) {  // a + (pad - (b + c))
  return Lin{a, b, c, 1, -1, -1, lf::K_PAD};
}
LC_HD Lin scale(const int* a, int k) { return Lin{a, nullptr, nullptr, k, 0, 0, 0}; }
LC_HD Lin add_twice(const int* a, const int* b) { return Lin{a, b, nullptr, 1, 2, 0, 0}; }
// limbs.fp_sub(a, b + c) (c may be null): a + (pad51 - (b + c)), 51 digits
LC_HD Lin limbs_sub(const int* a, const int* b, const int* c) {
  return Lin{a, b, c, 1, -1, -1, lf::K_PAD51};
}

// -- the block: which warp runs which step ------------------------------------

// A stage is walked twice: its products first, then its folds, numbered
// on from the products; step t runs on warp t % NW, in that warp's
// scratch.  So the heavy steps of a stage go to distinct warps.
template <int NW>
struct Ctx {
  int* scr;
  const int* K;
  int warp;
  int pass;  // 0: products, 1: folds
  int t;
  LC_MHD bool take(int kind, int*& S) {
    if (kind != pass) return false;
    const int w = t++ % NW;
    S = scr + w * SCR;
    return w == warp;
  }
};

template <int NW>
LC_HD void t_mul(Ctx<NW>& c, const int* a, const int* a2, const int* b, const int* b2, int* out) {
  int* S;
  if (c.take(0, S)) mul(a, a2, b, b2, out, S, c.K);
}

template <int BITS, int W = NL, int NW>
LC_HD void t_fold(Ctx<NW>& c, Lin in, int* out) {
  int* S;
  if (c.take(1, S)) fold<BITS, W>(in, out, S, c.K);
}

// Fq2 values, one step a component.
template <int NW>
LC_HD void fold2_entry(Ctx<NW>& c, const int* a, int* out) {  // loose -> semi-strict
  for (int h = 0; h < F2; h += NL) t_fold<22>(c, raw(a + h), out + h);
}
template <int NW>
LC_HD void add2(Ctx<NW>& c, const int* a, const int* b, int* out) {
  for (int h = 0; h < F2; h += NL) t_fold<10>(c, add(a + h, b + h), out + h);
}
template <int NW>
LC_HD void sub2(Ctx<NW>& c, const int* a, const int* b, int* out) {
  for (int h = 0; h < F2; h += NL) t_fold<13>(c, sub(a + h, b + h), out + h);
}
template <int BITS, int NW>
LC_HD void scale2(Ctx<NW>& c, const int* a, int k, int* out) {
  for (int h = 0; h < F2; h += NL) t_fold<BITS>(c, scale(a + h, k), out + h);
}

// m_fq2_mul in two stages through t (3 x 50): the three Karatsuba
// products, then out0 = t0 - t1 and out1 = t2 - (t0 + t1).
template <int NW>
LC_HD void fq2mul_products(Ctx<NW>& c, const int* a, const int* b, int* t) {
  t_mul(c, a, nullptr, b, nullptr, t);
  t_mul(c, a + NL, nullptr, b + NL, nullptr, t + NL);
  t_mul(c, a, a + NL, b, b + NL, t + 2 * NL);
}
template <int NW>
LC_HD void fq2mul_finish(Ctx<NW>& c, const int* t, int* out) {
  t_fold<13>(c, sub(t, t + NL), out);
  t_fold<13>(c, sub_sum(t + 2 * NL, t, t + NL), out + NL);
}

// m_fq2_sqr in two stages through t (d, then m): m = a0 a1 and
// d = a0 - a1, then out0 = (a0 + a1) d and out1 = 2m.
template <int NW>
LC_HD void fq2sqr_products(Ctx<NW>& c, const int* a, int* t) {
  t_mul(c, a, nullptr, a + NL, nullptr, t + NL);
  t_fold<13>(c, sub(a, a + NL), t);
}
template <int NW>
LC_HD void fq2sqr_finish(Ctx<NW>& c, const int* a, const int* t, int* out) {
  t_mul(c, a, a + NL, t, nullptr, out);
  t_fold<10>(c, scale(t + NL, 2), out + NL);
}

// -- the block: loads, stores, and the run of its rows' stages ----------------

// The words of the constant table a block of Row stages: all of it, or
// one, which stages nothing, under LF_COOP_K_GLOBAL (fold's and canon's
// own counts are beside their layouts).
template <template <int> class Row>
struct StagedK {
  static constexpr int WORDS = K_STAGED;
};

// The constant table and R row layouts Row<NW>, whose first members are
// in (the inputs) and out (the outputs).
template <template <int> class Row, int NW, int R>
struct Block : Warps<NW, R> {
  int K[StagedK<Row>::WORDS];
  Row<NW> row[R];
};

// Rows block * R .. block * R + R - 1 of the nin inputs, W digits a row
// (F2 for Fq2 values, NL for Fq), into each row's in; zeros for a row past
// n.  Returns the table the steps read: the block's copy of the table's
// first StagedK<Row>::WORDS words, staged here, or K itself when that is
// one word.
//
// A loop a row, here and in store_rows, and row 0 written out in
// run_stages for one row a block: ptxas's allocation of the ladder kernels
// (64 registers, with spills) moves with the form of this code, and on
// the H100 this form gave their one-row times back, where one flat loop
// over the block's rows cost lad2 12 % (PERF.md).
template <int W, template <int> class Row, int NW, int R>
LC_HD const int* load_rows(const float* const* in, int nin, int n, int block, const int* K,
                           Block<Row, NW, R>& s) {
  if constexpr (StagedK<Row>::WORDS > 1) {
    LC_BLOCK_FOR(i, StagedK<Row>::WORDS) s.K[i] = K[i];
    K = s.K;
  }
  for (int r = 0; r < R; ++r) {
    const int row = block * R + r;
    int* dst = reinterpret_cast<int*>(s.row[r].in);
    LC_BLOCK_FOR(j, nin * W) {
      const int k = j / W;
      dst[j] = row < n ? (int)in[k][row * W + (j - k * W)] : 0;
    }
  }
  LC_SYNC_BLOCK();
  return K;
}

template <int W, template <int> class Row, int NW, int R>
LC_HD void store_rows(const Block<Row, NW, R>& s, int nout, float* const* out, int n, int block) {
  for (int r = 0; r < R; ++r) {
    const int row = block * R + r;
    const int* src = reinterpret_cast<const int*>(s.row[r].out);
    if (row < n) {
      LC_BLOCK_FOR(j, nout * W) {
        const int k = j / W;
        out[k][row * W + (j - k * W)] = (float)src[j];
      }
    }
  }
}

// Run Stages<NW>{&row}(st, c) for st = 0..nstages-1 on every row, its
// products, then its folds, the steps reading the table k: warp w of the
// block is warp w % NW of row w / NW (written out for one row a block, so
// that the compiler sees row 0).  On the card every warp runs its own
// steps of a stage, then the block syncs; on the CPU the block's warps run
// one after the other.
template <template <int> class Stages, template <int> class Row, int NW, int R>
LC_HD void run_stages(Block<Row, NW, R>& s, const int* k, int nstages) {
#ifdef __CUDA_ARCH__
  const int w = (int)(threadIdx.x >> 5);
  Row<NW>& row = s.row[R == 1 ? 0 : w / NW];
  const Stages<NW> stage{&row};
  Ctx<NW> c{row.scr, k, R == 1 ? w : w % NW, 0, 0};
  for (int st = 0; st < nstages; ++st) {
    c.t = 0;
    for (c.pass = 0; c.pass < 2; ++c.pass) stage(st, c);
    LC_SYNC_BLOCK();
  }
#else
  for (int st = 0; st < nstages; ++st) {
    for (int i = 0; i < NW * R; ++i) {
#ifdef LC_HOST_REVERSED
      const int w = NW * R - 1 - i;
#else
      const int w = i;
#endif
      Row<NW>& row = s.row[w / NW];
      Ctx<NW> c{row.scr, k, w % NW, 0, 0};
      for (c.pass = 0; c.pass < 2; ++c.pass) Stages<NW>{&row}(st, c);
    }
  }
#endif
}

// -- fused_ladder._lad1_k ------------------------------------------------------

// in: x1 y1 z1 x2 y2 z2 (loose); out: z1z1 z2z2 a1 bb1 yz1 a2 bb2 yz2, i.e.
// z1^2, z2^2, then x^2, y^2 and y z of each doubling
template <int NW>
struct Lad1 {
  int in[6][F2];
  int out[8][F2];
  int f[6][F2];       // the inputs, folded
  int q[6][F2];       // their square temporaries
  int t[2][3 * NL];   // product temporaries of y1 z1 and y2 z2
  int scr[NW * SCR];
};

// The schedule (S = Fq step):
//   0: fold x1 y1 z1 x2 y2 z2                                      12 S
//   1: the six squares and two products (products)                12 mul + 6 S
//   2: the six squares and two products (finish)                  6 mul + 10 S
template <int NW>
struct Lad1Stages {
  Lad1<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Lad1<NW>& r = *s;
    switch (st) {
      case 0:
        for (int k = 0; k < 6; ++k) fold2_entry(c, r.in[k], r.f[k]);
        break;
      case 1:
        for (int k = 0; k < 6; ++k) fq2sqr_products(c, r.f[k], r.q[k]);
        fq2mul_products(c, r.f[1], r.f[2], r.t[0]);
        fq2mul_products(c, r.f[4], r.f[5], r.t[1]);
        break;
      default:
        // input k = x1 y1 z1 x2 y2 z2: its square is output 2 3 0 5 6 1
        for (int k = 0; k < 6; ++k)
          fq2sqr_finish(c, r.f[k], r.q[k], r.out[k % 3 == 2 ? k / 3 : 2 + 3 * (k / 3) + k % 3]);
        fq2mul_finish(c, r.t[0], r.out[4]);
        fq2mul_finish(c, r.t[1], r.out[7]);
        break;
    }
  }
};

template <int NW, int R>
LC_HD void block_lad1(const float* const* in, float* const* out, int n, int block,
                      const int* K, Block<Lad1, NW, R>& s) {
  const int* k = load_rows<F2>(in, 6, n, block, K, s);
  run_stages<Lad1Stages>(s, k, 3);
  store_rows<F2>(s, 8, out, n, block);
}

// -- fused_ladder._lad2_k ------------------------------------------------------

// in: x1 y1 x2 y2 (loose) z1z1 z2z2 a1 bb1 a2 bb2 (semi-strict);
// out: u1 u2 s1y s2y, then e x3 dmx c8 for each doubling d
template <int NW>
struct Lad2 {
  int in[10][F2];
  int out[12][F2];
  int xy[4][F2];                    // x1 y1 x2 y2, folded
  int qc[2][F2], qf[2][F2], qx[2][F2];  // square temporaries of cc, f, xbb2
  int cc[2][F2], f[2][F2], xbb[2][F2], xbb2[2][F2], ac[2][F2], dh[2][F2], dd[2][F2],
      d2[2][F2];
  int tu[4][3 * NL];                // product temporaries of u1 u2 s1y s2y
  int scr[NW * SCR];
};

// The schedule (products per stage, on distinct warps; S = Fq step):
//   0: cc = bb^2 (products) x2; fold x1 y1 x2 y2; e = 3a x2        2 mul + 14 S
//   1: f = e^2 (products) x2, cc (finish) x2, u1 (products),
//      xbb = x + bb x2                                             7 mul + 8 S
//   2: xbb2 = xbb^2 (products) x2, f (finish) x2, u2 (products),
//      ac = a + cc x2                                              7 mul + 8 S
//   3: xbb2 (finish) x2, s1y, s2y (products), u1, u2 (finish)      8 mul + 6 S
//   4: dh = xbb2 - ac x2, s1y, s2y (finish), c8 = 8cc x2           12 S
//   5: dd = 2dh; 6: d2 = 2dd; 7: x3 = f - d2; 8: dmx = dd - x3     4 S each
template <int NW>
struct Lad2Stages {
  Lad2<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Lad2<NW>& r = *s;
    const int* z1z1 = r.in[4];
    const int* z2z2 = r.in[5];
    switch (st) {
      case 0:
        for (int d = 0; d < 2; ++d) fq2sqr_products(c, r.in[7 + 2 * d], r.qc[d]);
        for (int k = 0; k < 4; ++k) fold2_entry(c, r.in[k], r.xy[k]);
        for (int d = 0; d < 2; ++d) scale2<10>(c, r.in[6 + 2 * d], 3, r.out[4 + 4 * d]);
        break;
      case 1:
        for (int d = 0; d < 2; ++d) fq2sqr_products(c, r.out[4 + 4 * d], r.qf[d]);
        for (int d = 0; d < 2; ++d) fq2sqr_finish(c, r.in[7 + 2 * d], r.qc[d], r.cc[d]);
        fq2mul_products(c, r.xy[0], z2z2, r.tu[0]);
        for (int d = 0; d < 2; ++d) add2(c, r.xy[2 * d], r.in[7 + 2 * d], r.xbb[d]);
        break;
      case 2:
        for (int d = 0; d < 2; ++d) fq2sqr_products(c, r.xbb[d], r.qx[d]);
        for (int d = 0; d < 2; ++d) fq2sqr_finish(c, r.out[4 + 4 * d], r.qf[d], r.f[d]);
        fq2mul_products(c, r.xy[2], z1z1, r.tu[1]);
        for (int d = 0; d < 2; ++d) add2(c, r.in[6 + 2 * d], r.cc[d], r.ac[d]);
        break;
      case 3:
        for (int d = 0; d < 2; ++d) fq2sqr_finish(c, r.xbb[d], r.qx[d], r.xbb2[d]);
        fq2mul_products(c, r.xy[1], z2z2, r.tu[2]);
        fq2mul_products(c, r.xy[3], z1z1, r.tu[3]);
        fq2mul_finish(c, r.tu[0], r.out[0]);
        fq2mul_finish(c, r.tu[1], r.out[1]);
        break;
      case 4:
        for (int d = 0; d < 2; ++d) sub2(c, r.xbb2[d], r.ac[d], r.dh[d]);
        fq2mul_finish(c, r.tu[2], r.out[2]);
        fq2mul_finish(c, r.tu[3], r.out[3]);
        for (int d = 0; d < 2; ++d) scale2<12>(c, r.cc[d], 8, r.out[7 + 4 * d]);
        break;
      case 5:
        for (int d = 0; d < 2; ++d) scale2<10>(c, r.dh[d], 2, r.dd[d]);
        break;
      case 6:
        for (int d = 0; d < 2; ++d) scale2<10>(c, r.dd[d], 2, r.d2[d]);
        break;
      case 7:
        for (int d = 0; d < 2; ++d) sub2(c, r.f[d], r.d2[d], r.out[5 + 4 * d]);
        break;
      default:
        for (int d = 0; d < 2; ++d) sub2(c, r.dd[d], r.out[5 + 4 * d], r.out[6 + 4 * d]);
        break;
    }
  }
};

template <int NW, int R>
LC_HD void block_lad2(const float* const* in, float* const* out, int n, int block,
                      const int* K, Block<Lad2, NW, R>& s) {
  const int* k = load_rows<F2>(in, 10, n, block, K, s);
  run_stages<Lad2Stages>(s, k, 9);
  store_rows<F2>(s, 12, out, n, block);
}

// -- fused_ladder._lad3_k ------------------------------------------------------

// in: z1 z2 (loose) u1 u2 s1y s2y z1z1 z2z2, then e dmx c8 yz for each
// doubling (semi-strict); out: x3 y3 z3 h sd y3d1 z3d1 y3d2 z3d2
template <int NW>
struct Lad3 {
  int in[16][F2];
  int out[9][F2];
  int z1[F2], z2[F2], zz[F2], hh[F2], zsum[F2], s1f[F2], s2f[F2], ed[2][F2], i2[F2],
      zsum2[F2], rr[F2], zd[F2], j[F2], v[F2], r2[F2], jv2[F2], vmx[F2], s1j[F2], s1j2[F2],
      rvx[F2];
  int t[4][3 * NL];  // product temporaries, each reused once its finish has run
  int q[2][F2];      // square temporaries
  int scr[NW * SCR];
};

// The schedule (S = Fq step; h and sd are outputs):
//   0: e1 dmx1, e2 dmx2 (products, t0 t1); fold z1 z2; h = u2 - u1;
//      zz = z1z1 + z2z2; z3d = 2yz x2                              6 mul + 12 S
//   1: s1f = s1y z2, s2f = s2y z1 (products, t2 t3); ed (finish) x2;
//      hh = 2h; zsum = z1 + z2                                     6 mul + 8 S
//   2: i2 = hh^2, zsum2 = zsum^2 (products, q0 q1); s1f, s2f (finish);
//      y3d = ed - c8 x2                                            2 mul + 10 S
//   3: i2, zsum2 (finish); sd = s2f - s1f                          2 mul + 4 S
//   4: j = h i2, v = u1 i2 (products, t0 t1); rr = 2sd;
//      zd = zsum2 - zz                                             6 mul + 4 S
//   5: z3 = zd h (products, t2); r2 = rr^2 (products, q0);
//      j, v (finish)                                               4 mul + 5 S
//   6: s1j = s1f j (products, t3); r2, z3 (finish); jv2 = j + 2v   4 mul + 5 S
//   7: x3 = r2 - jv2; s1j (finish)                                 4 S
//   8: vmx = v - x3; s1j2 = 2 s1j                                  4 S
//   9: rvx = rr vmx (products, t0)                                 3 mul
//  10: rvx (finish); 11: y3 = rvx - s1j2                           2 S each
template <int NW>
struct Lad3Stages {
  Lad3<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Lad3<NW>& r = *s;
    int* x3 = r.out[0];
    int* h = r.out[3];
    int* sd = r.out[4];
    switch (st) {
      case 0:
        for (int d = 0; d < 2; ++d) fq2mul_products(c, r.in[8 + 4 * d], r.in[9 + 4 * d], r.t[d]);
        fold2_entry(c, r.in[0], r.z1);
        fold2_entry(c, r.in[1], r.z2);
        sub2(c, r.in[3], r.in[2], h);
        add2(c, r.in[6], r.in[7], r.zz);
        for (int d = 0; d < 2; ++d) scale2<10>(c, r.in[11 + 4 * d], 2, r.out[6 + 2 * d]);
        break;
      case 1:
        fq2mul_products(c, r.in[4], r.z2, r.t[2]);
        fq2mul_products(c, r.in[5], r.z1, r.t[3]);
        for (int d = 0; d < 2; ++d) fq2mul_finish(c, r.t[d], r.ed[d]);
        scale2<10>(c, h, 2, r.hh);
        add2(c, r.z1, r.z2, r.zsum);
        break;
      case 2:
        fq2sqr_products(c, r.hh, r.q[0]);
        fq2sqr_products(c, r.zsum, r.q[1]);
        fq2mul_finish(c, r.t[2], r.s1f);
        fq2mul_finish(c, r.t[3], r.s2f);
        for (int d = 0; d < 2; ++d) sub2(c, r.ed[d], r.in[10 + 4 * d], r.out[5 + 2 * d]);
        break;
      case 3:
        fq2sqr_finish(c, r.hh, r.q[0], r.i2);
        fq2sqr_finish(c, r.zsum, r.q[1], r.zsum2);
        sub2(c, r.s2f, r.s1f, sd);
        break;
      case 4:
        fq2mul_products(c, h, r.i2, r.t[0]);
        fq2mul_products(c, r.in[2], r.i2, r.t[1]);
        scale2<10>(c, sd, 2, r.rr);
        sub2(c, r.zsum2, r.zz, r.zd);
        break;
      case 5:
        fq2mul_products(c, r.zd, h, r.t[2]);
        fq2sqr_products(c, r.rr, r.q[0]);
        fq2mul_finish(c, r.t[0], r.j);
        fq2mul_finish(c, r.t[1], r.v);
        break;
      case 6:
        fq2mul_products(c, r.s1f, r.j, r.t[3]);
        fq2sqr_finish(c, r.rr, r.q[0], r.r2);
        fq2mul_finish(c, r.t[2], r.out[2]);
        for (int hf = 0; hf < F2; hf += NL) t_fold<10>(c, add_twice(r.j + hf, r.v + hf), r.jv2 + hf);
        break;
      case 7:
        sub2(c, r.r2, r.jv2, x3);
        fq2mul_finish(c, r.t[3], r.s1j);
        break;
      case 8:
        sub2(c, r.v, x3, r.vmx);
        scale2<10>(c, r.s1j, 2, r.s1j2);
        break;
      case 9:
        fq2mul_products(c, r.rr, r.vmx, r.t[0]);
        break;
      case 10:
        fq2mul_finish(c, r.t[0], r.rvx);
        break;
      default:
        sub2(c, r.rvx, r.s1j2, r.out[1]);
        break;
    }
  }
};

template <int NW, int R>
LC_HD void block_lad3(const float* const* in, float* const* out, int n, int block,
                      const int* K, Block<Lad3, NW, R>& s) {
  const int* k = load_rows<F2>(in, 16, n, block, K, s);
  run_stages<Lad3Stages>(s, k, 12);
  store_rows<F2>(s, 9, out, n, block);
}

// -- fused_core._fq2pow16mul_k -------------------------------------------------

// in: r t (loose); out: r^16 t
template <int NW>
struct Fq2Pow16Mul {
  int in[2][F2];
  int out[F2];
  int r[2][F2];      // r folded, then its squares, alternately
  int t[F2];         // t folded
  int q[F2];         // square temporaries
  int kt[3 * NL];    // product temporaries
  int scr[NW * SCR];
};

// The schedule, serial by nature (S = Fq step):
//   0: fold r t                                                     4 S
//   1 + 2i: square i of r (products); 2 + 2i: (finish), i = 0..3    1 mul + 1 S each
//   9: r t (products); 10: (finish)                                 3 mul; 2 S
template <int NW>
struct Fq2Pow16MulStages {
  Fq2Pow16Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Fq2Pow16Mul<NW>& r = *s;
    const int i = (st - 1) / 2;  // the square of stages 1..8
    if (st == 0) {
      fold2_entry(c, r.in[0], r.r[0]);
      fold2_entry(c, r.in[1], r.t);
    } else if (st <= 8 && st % 2 == 1) {
      fq2sqr_products(c, r.r[i % 2], r.q);
    } else if (st <= 8) {
      fq2sqr_finish(c, r.r[i % 2], r.q, r.r[(i + 1) % 2]);
    } else if (st == 9) {
      fq2mul_products(c, r.r[0], r.t, r.kt);
    } else {
      fq2mul_finish(c, r.kt, r.out);
    }
  }
};

template <int NW, int R>
LC_HD void block_fq2pow16mul(const float* const* in, float* const* out, int n, int block,
                             const int* K, Block<Fq2Pow16Mul, NW, R>& s) {
  const int* k = load_rows<F2>(in, 2, n, block, K, s);
  run_stages<Fq2Pow16MulStages>(s, k, 11);
  store_rows<F2>(s, 1, out, n, block);
}

// -- fused_core._fq2mul_k ------------------------------------------------------

// in: a b (loose); out: a b in Fq2
template <int NW>
struct Fq2Mul {
  int in[2][F2];
  int out[F2];
  int f[2][F2];    // a and b folded
  int t[3 * NL];   // the three products
  int scr[NW * SCR];
};

// The schedule (S = Fq step; at most 3 steps at once):
//   0: fold a0 a1 b0 b1                                             4 S
//   1: a0 b0, a1 b1, (a0 + a1)(b0 + b1)                             3 mul
//   2: out0 = t0 - t1, out1 = t2 - (t0 + t1)                        2 S
template <int NW>
struct Fq2MulStages {
  Fq2Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Fq2Mul<NW>& r = *s;
    if (st == 0) {
      fold2_entry(c, r.in[0], r.f[0]);
      fold2_entry(c, r.in[1], r.f[1]);
    } else if (st == 1) {
      fq2mul_products(c, r.f[0], r.f[1], r.t);
    } else {
      fq2mul_finish(c, r.t, r.out);
    }
  }
};

template <int NW, int R>
LC_HD void block_fq2mul(const float* const* in, float* const* out, int n, int block,
                        const int* K, Block<Fq2Mul, NW, R>& s) {
  const int* k = load_rows<F2>(in, 2, n, block, K, s);
  run_stages<Fq2MulStages>(s, k, 3);
  store_rows<F2>(s, 1, out, n, block);
}

// -- fused_core._pow16mul_k ----------------------------------------------------

// in: r t (loose, Fq); out: r^16 t
template <int NW>
struct Pow16Mul {
  int in[2][NL];
  int out[NL];
  int r[2][NL];   // r folded, then its squares, alternately
  int t[NL];      // t folded
  int scr[NW * SCR];
};

// The schedule, serial by nature (S = Fq step):
//   0: fold r t                                                     2 S
//   1 + i: square i of r, from r[i % 2] into r[(i + 1) % 2]         1 mul each
//   5: r t                                                          1 mul
template <int NW>
struct Pow16MulStages {
  Pow16Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Pow16Mul<NW>& r = *s;
    if (st == 0) {
      t_fold<22>(c, raw(r.in[0]), r.r[0]);
      t_fold<22>(c, raw(r.in[1]), r.t);
    } else if (st <= 4) {
      const int i = st - 1;
      t_mul(c, r.r[i % 2], nullptr, r.r[i % 2], nullptr, r.r[(i + 1) % 2]);
    } else {
      t_mul(c, r.r[0], nullptr, r.t, nullptr, r.out);
    }
  }
};

template <int NW, int R>
LC_HD void block_pow16mul(const float* const* in, float* const* out, int n, int block,
                          const int* K, Block<Pow16Mul, NW, R>& s) {
  const int* k = load_rows<NL>(in, 2, n, block, K, s);
  run_stages<Pow16MulStages>(s, k, 6);
  store_rows<NL>(s, 1, out, n, block);
}

// -- fused_core._mul_k ---------------------------------------------------------

// in: a b (loose, Fq); out: a b
template <int NW>
struct Mul {
  int in[2][NL];
  int out[NL];
  int f[2][NL];   // a and b folded
  int scr[NW * SCR];
};

// The schedule (S = Fq step):
//   0: fold a b                                                     2 S
//   1: a b                                                          1 mul
template <int NW>
struct MulStages {
  Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Mul<NW>& r = *s;
    if (st == 0) {
      t_fold<22>(c, raw(r.in[0]), r.f[0]);
      t_fold<22>(c, raw(r.in[1]), r.f[1]);
    } else {
      t_mul(c, r.f[0], nullptr, r.f[1], nullptr, r.out);
    }
  }
};

template <int NW, int R>
LC_HD void block_mul(const float* const* in, float* const* out, int n, int block,
                     const int* K, Block<Mul, NW, R>& s) {
  const int* k = load_rows<NL>(in, 2, n, block, K, s);
  run_stages<MulStages>(s, k, 2);
  store_rows<NL>(s, 1, out, n, block);
}

// -- fused_core._fq2sqr_k ------------------------------------------------------

// in: a (loose); out: a^2 in Fq2, then a folded
template <int NW>
struct Fq2Sqr {
  int in[1][F2];
  int out[2][F2];
  int q[F2];      // the square's temporaries
  int scr[NW * SCR];
};

// The schedule (S = Fq step; at most 2 steps at once):
//   0: fold a0 a1 into out1                                         2 S
//   1: m = a0 a1 (products), d = a0 - a1                            1 mul + 1 S
//   2: out0 = (a0 + a1) d, then 2m                                  1 mul + 1 S
template <int NW>
struct Fq2SqrStages {
  Fq2Sqr<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    Fq2Sqr<NW>& r = *s;
    if (st == 0) {
      fold2_entry(c, r.in[0], r.out[1]);
    } else if (st == 1) {
      fq2sqr_products(c, r.out[1], r.q);
    } else {
      fq2sqr_finish(c, r.out[1], r.q, r.out[0]);
    }
  }
};

template <int NW, int R>
LC_HD void block_fq2sqr(const float* const* in, float* const* out, int n, int block,
                        const int* K, Block<Fq2Sqr, NW, R>& s) {
  const int* k = load_rows<F2>(in, 1, n, block, K, s);
  run_stages<Fq2SqrStages>(s, k, 3);
  store_rows<F2>(s, 2, out, n, block);
}

// -- fused_core._fold_k --------------------------------------------------------

// in: x (loose, Fq); out: x folded (semi-strict)
template <int NW>
struct Fold {
  int in[1][NL];
  int out[NL];
  int scr[NW * SCR];
};

// The schedule: 0: the entry fold                                   1 S
template <int NW>
struct FoldStages {
  Fold<NW>* s;
  LC_MHD void operator()(int, Ctx<NW>& c) const { t_fold<22>(c, raw(s->in[0]), s->out); }
};

// The table's words fold reads: the three RED rows of m_fold at the bound
// 22, the table's first 150 (LF_FOLD_K_STAGED=1 stages them, 0 reads them
// from global memory)
#if LF_FOLD_K_STAGED && !defined(LF_COOP_K_GLOBAL)
constexpr int FOLD_K_WORDS = (NL + lf::carry_extra(22) - (NL - 1)) * NL;
#else
constexpr int FOLD_K_WORDS = 1;
#endif
static_assert(lf::K_RED == 0, "fold stages the table's first words");
template <>
struct StagedK<Fold> {
  static constexpr int WORDS = FOLD_K_WORDS;
};

template <int NW, int R>
LC_HD void block_fold(const float* const* in, float* const* out, int n, int block,
                      const int* K, Block<Fold, NW, R>& s) {
  const int* k = load_rows<NL>(in, 1, n, block, K, s);
  run_stages<FoldStages>(s, k, 1);
  store_rows<NL>(s, 1, out, n, block);
}

// -- fused_core._canon_k -------------------------------------------------------

// The inputs of an exact ripple: digit i of a buffer of WIN digits (zero
// above), the difference x + (255 - q) + [i = 0] of two 51-digit buffers,
// and cond_sub's t = r' + (255 - c) + [i = 0] over the 50 digits of
// r' = (s[50] = 1 ? s : r) (r itself when s is null) and a constant c.
template <int WIN>
struct Digits {
  const int* x;
  LC_MHD int operator()(int i) const { return i < WIN ? x[i] : 0; }
};
struct Diff {
  const int *x, *q;
  LC_MHD int operator()(int i) const { return x[i] + (255 - q[i]) + (i == 0); }
};
struct CondSub {
  const int *r, *s, *c;
  LC_MHD int pick(int i) const { return s && s[NL] == 1 ? s[i] : r[i]; }
  LC_MHD int operator()(int i) const { return i < NL ? pick(i) + (255 - c[i]) + (i == 0) : 0; }
};
struct Buf {
  const int* x;
  LC_MHD int operator()(int i) const { return x[i]; }
};

// One carry pass of W digits from a functor into dst; the top carry is
// dropped.
template <int W, class In>
LC_HD void carry_from(In in, int* dst) {
  LC_LANE_FOR(i, W) {
    LC_BOUND(CANON_RIPPLE, in(i));
    dst[i] = (in(i) & 255) + (i == 0 ? 0 : in(i - 1) >> 8);
    LC_BOUND(CARRY_PASS, dst[i]);
  }
  LC_SYNC_WARP();
}

// Four words, for 16-byte loads of the carry flags.
struct alignas(16) Quad {
  unsigned a, b, c, d;
};

// The 0/1 carries of W digits, LAST = 1: after one more carry pass of in,
// LAST = 0: of in itself; every digit then is at most 256.  Lane l takes
// the digit pair 2l, 2l + 1: its digits v and its flags G (the carry out
// of the pair with no carry in: a digit of 256 generates, 255
// propagates) and P (both digits 255), written as G << l and P << l.
// Every lane then ORs the NP words of each into the masks g and p, and
// the carries into the pairs are the bits of ((g | p) + g) ^ (g | p) ^ g
// (the binary carries of that sum: into bit l + 1 comes g_l, or p_l and
// the carry into bit l).  dst gets the value mod 256^W in strict digits.
template <int W, int LAST, class In>
LC_HD void carry_bits(In in, int* dst, int* S) {
  constexpr int NP = (W + 1) / 2;
  constexpr int NQ = (NP + 3) / 4;  // quads of flag words
  static_assert(2 * NP <= RF - RV && NP <= 31 && RF + 8 * NQ <= SCR && RF % 4 == 0,
                "ripple outside the scratch");
  int* v = S + RV;
#if defined(__CUDA_ARCH__) && defined(LF_CANON_BALLOT)
  // a variant for the card tests: digits l and l + 32 on lane l, the
  // flags as warp ballots
  (void)v;
  const int l = (int)(threadIdx.x & 31u);
  int d0 = 0, d1 = 0;
  if (l < W) d0 = LAST ? (in(l) & 255) + (l == 0 ? 0 : in(l - 1) >> 8) : in(l);
  if (l + 32 < W) d1 = LAST ? (in(l + 32) & 255) + (in(l + 31) >> 8) : in(l + 32);
  const unsigned long long g = __ballot_sync(0xffffffffu, d0 >> 8) |
                               (unsigned long long)__ballot_sync(0xffffffffu, d1 >> 8) << 32;
  const unsigned long long gp = __ballot_sync(0xffffffffu, (d0 + 1) >> 8) |
                                (unsigned long long)__ballot_sync(0xffffffffu, (d1 + 1) >> 8) << 32;
  const unsigned long long c = (gp + g) ^ gp ^ g;
  if (l < W) dst[l] = (d0 + (int)((c >> l) & 1)) & 255;
  if (l + 32 < W) dst[l + 32] = (d1 + (int)((c >> (l + 32)) & 1)) & 255;
  __syncwarp();
#else
  unsigned* fg = reinterpret_cast<unsigned*>(S + RF);
  unsigned* fp = fg + 4 * NQ;
  LC_LANE_FOR(l, 4 * NQ) {
    const int a = 2 * l, b = a + 1;
    int va = 0, vb = 0;
    if (l < NP) {
      if (LAST) {
        const int xa = in(a);
        LC_BOUND(CANON_RIPPLE, xa);
        va = (xa & 255) + (a == 0 ? 0 : in(a - 1) >> 8);
        if (b < W) {
          LC_BOUND(CANON_RIPPLE, in(b));
          vb = (in(b) & 255) + (xa >> 8);
        }
      } else {
        va = in(a);
        LC_BOUND(CANON_RIPPLE, va);
        if (b < W) {
          vb = in(b);
          LC_BOUND(CANON_RIPPLE, vb);
        }
      }
      v[a] = va;
      v[b] = vb;
    }
    const unsigned ga = va >> 8, pa = ((va + 1) >> 8) ^ ga;
    const unsigned gb = vb >> 8, pb = ((vb + 1) >> 8) ^ gb;
    fg[l] = (gb | (pb & ga)) << l;
    fp[l] = (pa & pb) << l;
  }
  LC_SYNC_WARP();
  LC_LANE_FOR(l, NP) {
    unsigned g = 0, p = 0;
    for (int q = 0; q < NQ; ++q) {  // the masks, every lane
      const Quad x = reinterpret_cast<const Quad*>(fg)[q];
      const Quad y = reinterpret_cast<const Quad*>(fp)[q];
      g |= x.a | x.b | x.c | x.d;
      p |= y.a | y.b | y.c | y.d;
    }
    const unsigned gp = g | p;
    const unsigned c = (gp + g) ^ gp ^ g;  // bit l: the carry into pair l
    const int a = 2 * l, b = a + 1;
    const int ta = v[a] + (int)((c >> l) & 1u);
    dst[a] = ta & 255;
    if (b < W) dst[b] = (v[b] + (ta >> 8)) & 255;
  }
  LC_SYNC_WARP();
#endif
}

// lf's exact ripple of W digits in(0..W-1), each at most 2^BITS - 1 (or
// 256: BITS = 8), into dst: carry_passes(BITS) value-preserving passes,
// the first reading in, each writing another buffer, the last taken
// inside carry_bits.
template <int W, int BITS, class In>
LC_HD void ripple(In in, int* dst, int* S) {
  constexpr int PASSES = lf::carry_passes(BITS);
  static_assert(W <= RB - RA, "ripple outside the scratch");
  if constexpr (PASSES <= 1) {
    carry_bits<W, PASSES>(in, dst, S);
    return;
  }
  int* a = S + RA;
  int* b = S + RB;
  carry_from<W>(in, a);
  for (int p = 2; p < PASSES; ++p) {
    carry_from<W>(Buf{a}, b);
    int* t = a;
    a = b;
    b = t;
  }
  carry_bits<W, 1>(Buf{a}, dst, S);
}

// in: x (loose, Fq); canon's output, the canonical residue, goes straight
// to global memory
template <int NW>
struct Canon {
  int in[1][NL];
  int f[NL];         // x folded
  int x[NL + 1];     // its 51 strict digits
  int qc[NL + 1];    // q p's columns
  int qr[NL + 1];    // their strict digits
  int r[NL + 1];     // x - q p, strict
  int s[2][NL + 1];  // r - 2p, then r' - p, strict (s[50] = 1: no borrow)
  alignas(16) int scr[NW * SCR];
};

// The table's words canon reads: the three RED rows of fold<50, 22>
// (K_RED..), then mu, p (48 digits), p and 2p (K_MU.., one run).
constexpr int CANON_K_TAIL = lf::K_P2C + NL - lf::K_MU;
constexpr int CANON_K_WORDS = 3 * NL + CANON_K_TAIL;
#if LF_CANON_K_STAGED && !defined(LF_COOP_K_GLOBAL)
constexpr bool CANON_STAGED = true;
#else
constexpr bool CANON_STAGED = false;
#endif
template <>
struct StagedK<Canon> {
  static constexpr int WORDS = CANON_STAGED ? CANON_K_WORDS : 1;
};

// One row on one warp, in the order of lf's serial canon (the entry fold;
// the ripple to 51 digits; the Barrett quotient from the top 4 digits
// with mu = floor(2^424 / p) and its ripple, whose three digits every lane
// needs and computes; q p and its ripple; x - q p and its ripple; the
// conditional subtractions of 2p and of p, each a ripple whose top digit,
// the no-borrow flag, all lanes read back), its table K (the RED rows at
// K_RED) and kt (mu at kt[0], K_MU's run).
template <int NW>
LC_HD void canon_row(const float* in, float* out, int row, const int* K, const int* kt,
                     Canon<NW>& r) {
  int* S = r.scr;
  const int* mu = kt;
  const int* p48 = kt + (lf::K_P48 - lf::K_MU);
  const int* pc = kt + (lf::K_PC - lf::K_MU);
  const int* p2c = kt + (lf::K_P2C - lf::K_MU);
  LC_LANE_FOR(j, NL) r.in[0][j] = (int)in[row * NL + j];
  LC_SYNC_WARP();
  fold<22>(raw(r.in[0]), r.f, S, K);
  ripple<NL + 1, 8>(Digits<NL>{r.f}, r.x, S);
  // the quotient q = zr[6..8], zr the strict digits of the 11 columns of
  // x[47..50] mu: a serial ripple of columns 0..8 that every lane runs in
  // registers (on the CPU once), each column below 4 * 255^2 < 2^18
  int carry = 0, q0 = 0, q1 = 0, q2 = 0;
  for (int k = 0; k < 9; ++k) {
    int z = carry;
    for (int i = 0; i < 4; ++i)
      if (k - i >= 0 && k - i < 6) z += r.x[47 + i] * mu[k - i];
    LC_BOUND(CANON_BARRETT, z);
    if (k == 6) q0 = z & 255;
    if (k == 7) q1 = z & 255;
    if (k == 8) q2 = z & 255;
    carry = z >> 8;
  }
  LC_LANE_FOR(k, NL + 1) {
    int q = 0;
    if (k < 48) q += q0 * p48[k];
    if (k >= 1 && k - 1 < 48) q += q1 * p48[k - 1];
    if (k >= 2 && k - 2 < 48) q += q2 * p48[k - 2];
    LC_BOUND(CANON_QP, q);
    r.qc[k] = q;
  }
  LC_SYNC_WARP();
  ripple<NL + 1, 18>(Buf{r.qc}, r.qr, S);
  ripple<NL + 1, 9>(Diff{r.x, r.qr}, r.r, S);
  ripple<NL + 1, 9>(CondSub{r.r, nullptr, p2c}, r.s[0], S);
  ripple<NL + 1, 9>(CondSub{r.r, r.s[0], pc}, r.s[1], S);
  const CondSub last{r.r, r.s[0], pc};
  LC_LANE_FOR(k, NL) out[row * NL + k] = (float)(r.s[1][NL] == 1 ? r.s[1][k] : last.pick(k));
}

template <int NW, int R>
LC_HD void block_canon(const float* const* in, float* const* out, int n, int block,
                       const int* K, Block<Canon, NW, R>& s) {
  static_assert(NW == 1, "canon runs one warp a row");
  const int* kt = K + lf::K_MU;
  if constexpr (CANON_STAGED) {
    LC_BLOCK_FOR(i, CANON_K_WORDS) s.K[i] = K[i < 3 * NL ? lf::K_RED + i : lf::K_MU + i - 3 * NL];
    LC_SYNC_BLOCK();
    K = s.K;
    kt = s.K + 3 * NL;
  }
#ifdef __CUDA_ARCH__
  const int w = (int)(threadIdx.x >> 5);
  if (block * R + w < n) canon_row(in[0], out[0], block * R + w, K, kt, s.row[w]);
#else
  for (int i = 0; i < R; ++i) {
#ifdef LC_HOST_REVERSED
    const int w = R - 1 - i;
#else
    const int w = i;
#endif
    if (block * R + w < n) canon_row(in[0], out[0], block * R + w, K, kt, s.row[w]);
  }
#endif
}

// -- pallas_fuse(tower.fq2_mul): the JAX limbs library's Fq2 product ------------

// in: a b (semi-strict); out: a b in Fq2, in the digits of the JAX limbs
// library's tower.fq2_mul
template <int NW>
struct LibFq2Mul {
  int in[2][F2];
  int out[F2];
  int t[3 * NL];  // the products t0 t1 t2
  int s[F2];      // the strict sums sa = strict(a0 + a1), sb = strict(b0 + b1)
  int scr[NW * SCR];
};

// The limbs steps, each with the limbs library's carry counts: fp_strict of
// a sum is fold<24> of 50 digits; fp_mul is mul; fp_sub is fold<24> of
// limbs_sub's 51 digits, 53 columns with the headroom, whose 3 output
// passes (reduce's, at bound 22) are limbs._finalize's carry at bound 23.
// The Karatsuba follows the limbs algorithm, not the fused path's
// (fq2mul_products multiplies the unfolded sums): t2 is the product of the
// strict sums, and out1 = fp_sub(t2, t0 + t1).
// The schedule (S = Fq step; a fold reads no product of its own stage):
//   0: t0 = a0 b0, t1 = a1 b1 (products); sa, sb                   2 mul + 2 S
//   1: t2 = sa sb (product); out0 = fp_sub(t0, t1)                 1 mul + 1 S
//   2: out1 = fp_sub(t2, t0 + t1)                                  1 S
static_assert(lf::carry_passes(22) == lf::carry_passes(23),
              "reduce's output passes stand for limbs' carry at bound 23");
template <int NW>
struct LibFq2MulStages {
  LibFq2Mul<NW>* s;
  LC_MHD void operator()(int st, Ctx<NW>& c) const {
    LibFq2Mul<NW>& r = *s;
    const int* a = r.in[0];
    const int* b = r.in[1];
    if (st == 0) {
      t_mul(c, a, nullptr, b, nullptr, r.t);
      t_mul(c, a + NL, nullptr, b + NL, nullptr, r.t + NL);
      t_fold<24>(c, add(a, a + NL), r.s);
      t_fold<24>(c, add(b, b + NL), r.s + NL);
    } else if (st == 1) {
      t_mul(c, r.s, nullptr, r.s + NL, nullptr, r.t + 2 * NL);
      t_fold<24, NL + 1>(c, limbs_sub(r.t, r.t + NL, nullptr), r.out);
    } else {
      t_fold<24, NL + 1>(c, limbs_sub(r.t + 2 * NL, r.t, r.t + NL), r.out + NL);
    }
  }
};

template <int NW, int R>
LC_HD void block_library_fq2_mul(const float* const* in, float* const* out, int n, int block,
                                 const int* K, Block<LibFq2Mul, NW, R>& s) {
  const int* k = load_rows<F2>(in, 2, n, block, K, s);
  run_stages<LibFq2MulStages>(s, k, 3);
  store_rows<F2>(s, 1, out, n, block);
}

// -- the kernels' blocks (warps a row, rows a block) ----------------------------

using Lad1Block = Block<Lad1, LAD_WARPS, 1>;
using Lad2Block = Block<Lad2, LAD_WARPS, 1>;
using Lad3Block = Block<Lad3, LAD_WARPS, 1>;
using Fq2Pow16MulBlock = Block<Fq2Pow16Mul, POW_WARPS, 1>;
using Fq2MulBlock = Block<Fq2Mul, FQ2MUL_WARPS, FQ2MUL_ROWS>;
using Pow16MulBlock = Block<Pow16Mul, 1, POW16_ROWS>;
using MulBlock = Block<Mul, MUL_WARPS, MUL_ROWS>;
using Fq2SqrBlock = Block<Fq2Sqr, FQ2SQR_WARPS, FQ2SQR_ROWS>;
using FoldBlock = Block<Fold, 1, FOLD_ROWS>;
using LibFq2MulBlock = Block<LibFq2Mul, LIB_FQ2MUL_WARPS, LIB_FQ2MUL_ROWS>;
// canon's registers sized for 2,048 threads a SM (32 a thread), so that
// the 5,120 one-warp rows of its largest launch fit one wave
struct CanonBlock : Block<Canon, 1, CANON_ROWS> {
  static constexpr int MIN_BLOCKS = 2048 / THREADS;
};

}  // namespace lfc
