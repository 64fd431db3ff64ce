/* fastbls: native BLS12-381 batch signature verification.
 *
 * The CPU-side counterpart of the TPU kernels (lodestar_tpu/ops/):
 *  - the honest CPU baseline for bench.py (blst-class role: the reference's
 *    native dep @chainsafe/blst, SURVEY.md section 2.9 - supranational C/asm;
 *    this is portable C with 64-bit Montgomery limbs, no asm),
 *  - the host-side final exponentiation for the split TPU dispatch (the
 *    batched Miller product is batch-parallel work the device keeps; the
 *    single-element final exp is serial work the host does faster),
 *  - a fast CPU fallback verifier behind the IBlsVerifier boundary.
 *
 * All algorithms mirror the Python bigint oracle (crypto/bls/) which is
 * itself differential-tested against RFC 9380 vectors and the device
 * kernels.  Constants are generated (tools/gen_fastbls_consts.py), never
 * transcribed.
 *
 * Representation: Fq = 6 x uint64 little-endian limbs, Montgomery form
 * (R = 2^384).  Towers: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)),
 * Fq12 = Fq6[w]/(w^2-v).  Miller loop uses the same inversion-free
 * jacobian line formulas as ops/pairing.py (lines scaled by Fq2 subfield
 * factors, killed by the easy part of the final exponentiation); the hard
 * part uses the BLS12 x-chain computing f^(3*lambda) - is-one verdicts and
 * pairing-equality checks are unaffected by the cube (gcd(3, r) = 1).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#include "fastbls_consts.h"

typedef struct { uint64_t d[6]; } fp_t;
typedef struct { fp_t c0, c1; } fp2_t;
typedef struct { fp2_t c0, c1, c2; } fp6_t;
typedef struct { fp6_t c0, c1; } fp12_t;
typedef struct { fp_t x, y, z; } g1_t;   /* jacobian; z==0 => infinity */
typedef struct { fp2_t x, y, z; } g2_t;  /* jacobian; z==0 => infinity */

/* ---------------------------------------------------------------- fp --- */

static const fp_t FP_ZERO = {{0, 0, 0, 0, 0, 0}};

static inline void fp_copy(fp_t *r, const fp_t *a) { *r = *a; }

static inline int fp_is_zero(const fp_t *a) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a->d[i];
    return acc == 0;
}

static inline int fp_equal(const fp_t *a, const fp_t *b) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a->d[i] ^ b->d[i];
    return acc == 0;
}

/* r = a - p if a >= p */
static inline void fp_reduce_once(fp_t *a) {
    uint64_t t[6];
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        unsigned __int128 diff = (unsigned __int128)a->d[i] - FB_P[i] - (uint64_t)borrow;
        t[i] = (uint64_t)diff;
        borrow = (diff >> 64) & 1; /* 1 if borrowed */
    }
    if (!borrow)
        for (int i = 0; i < 6; i++) a->d[i] = t[i];
}

static inline void fp_add(fp_t *r, const fp_t *a, const fp_t *b) {
    unsigned __int128 carry = 0;
    for (int i = 0; i < 6; i++) {
        carry += (unsigned __int128)a->d[i] + b->d[i];
        r->d[i] = (uint64_t)carry;
        carry >>= 64;
    }
    fp_reduce_once(r);
}

static inline void fp_sub(fp_t *r, const fp_t *a, const fp_t *b) {
    unsigned __int128 borrow = 0;
    uint64_t t[6];
    for (int i = 0; i < 6; i++) {
        unsigned __int128 diff = (unsigned __int128)a->d[i] - b->d[i] - (uint64_t)borrow;
        t[i] = (uint64_t)diff;
        borrow = (diff >> 64) & 1;
    }
    if (borrow) { /* add p back */
        unsigned __int128 carry = 0;
        for (int i = 0; i < 6; i++) {
            carry += (unsigned __int128)t[i] + FB_P[i];
            t[i] = (uint64_t)carry;
            carry >>= 64;
        }
    }
    for (int i = 0; i < 6; i++) r->d[i] = t[i];
}

static inline void fp_neg(fp_t *r, const fp_t *a) {
    if (fp_is_zero(a)) { *r = FP_ZERO; return; }
    fp_t p; memcpy(p.d, FB_P, sizeof p.d);
    fp_sub(r, &p, a);
}

static inline void fp_dbl(fp_t *r, const fp_t *a) { fp_add(r, a, a); }

/* CIOS Montgomery multiplication. */
static void fp_mul(fp_t *r, const fp_t *a, const fp_t *b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        unsigned __int128 carry = 0;
        uint64_t ai = a->d[i];
        for (int j = 0; j < 6; j++) {
            carry += (unsigned __int128)ai * b->d[j] + t[j];
            t[j] = (uint64_t)carry;
            carry >>= 64;
        }
        carry += t[6];
        t[6] = (uint64_t)carry;
        t[7] = (uint64_t)(carry >> 64);

        uint64_t m = t[0] * FB_PINV;
        carry = (unsigned __int128)m * FB_P[0] + t[0];
        carry >>= 64;
        for (int j = 1; j < 6; j++) {
            carry += (unsigned __int128)m * FB_P[j] + t[j];
            t[j - 1] = (uint64_t)carry;
            carry >>= 64;
        }
        carry += t[6];
        t[5] = (uint64_t)carry;
        t[6] = t[7] + (uint64_t)(carry >> 64);
        t[7] = 0;
    }
    for (int i = 0; i < 6; i++) r->d[i] = t[i];
    /* t may still be >= p (but < 2p given p < 2^383) */
    fp_reduce_once(r);
}

static inline void fp_sqr(fp_t *r, const fp_t *a) { fp_mul(r, a, a); }

/* MSB-first square-and-multiply; e given as 6 LE limbs. */
static void fp_pow(fp_t *r, const fp_t *a, const uint64_t e[6]) {
    fp_t result, base = *a;
    memcpy(result.d, FB_R1, sizeof result.d); /* mont(1) */
    int top = 5;
    while (top >= 0 && e[top] == 0) top--;
    if (top < 0) { *r = result; return; }
    int bit = 63;
    while (!((e[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int j = (i == top ? bit : 63); j >= 0; j--) {
            fp_sqr(&result, &result);
            if ((e[i] >> j) & 1) fp_mul(&result, &result, &base);
        }
    }
    *r = result;
}

static void fp_inv(fp_t *r, const fp_t *a) { fp_pow(r, a, FB_P_MINUS_2); }

/* sqrt for p % 4 == 3: a^((p+1)/4); returns 1 on success. */
static int fp_sqrt(fp_t *r, const fp_t *a) {
    fp_t root, chk;
    fp_pow(&root, a, FB_P_PLUS_1_DIV_4);
    fp_sqr(&chk, &root);
    if (!fp_equal(&chk, a)) return 0;
    *r = root;
    return 1;
}

static void fp_from_mont(fp_t *r, const fp_t *a) {
    /* multiply by 1 (non-mont): one Montgomery reduction */
    fp_t one = FP_ZERO;
    one.d[0] = 1;
    fp_mul(r, a, &one);
}

static void fp_to_mont(fp_t *r, const fp_t *a) {
    fp_t r2; memcpy(r2.d, FB_R2, sizeof r2.d);
    fp_mul(r, a, &r2);
}

/* big-endian 48-byte I/O (values in [0, p)); returns 0 if out of range */
static int fp_from_bytes(fp_t *r, const uint8_t *in) {
    fp_t v;
    for (int i = 0; i < 6; i++) {
        uint64_t limb = 0;
        for (int j = 0; j < 8; j++) limb = (limb << 8) | in[(5 - i) * 8 + j];
        v.d[i] = limb;
    }
    /* range check v < p */
    int lt = 0;
    for (int i = 5; i >= 0; i--) {
        if (v.d[i] < FB_P[i]) { lt = 1; break; }
        if (v.d[i] > FB_P[i]) { lt = 0; break; }
    }
    if (!lt) return 0;
    fp_to_mont(r, &v);
    return 1;
}

static void fp_to_bytes(uint8_t *out, const fp_t *a) {
    fp_t v;
    fp_from_mont(&v, a);
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            out[(5 - i) * 8 + j] = (uint8_t)(v.d[i] >> (8 * (7 - j)));
}

/* lexicographic "greater than (p-1)/2" on the non-mont value */
static int fp_is_lex_greater(const fp_t *a) {
    fp_t v;
    fp_from_mont(&v, a);
    for (int i = 5; i >= 0; i--) {
        if (v.d[i] > FB_P_MINUS_1_DIV_2[i]) return 1;
        if (v.d[i] < FB_P_MINUS_1_DIV_2[i]) return 0;
    }
    return 1; /* equal: not greater, but (p-1)/2 is not attainable by y of a curve point pair midpoint; treat as not greater */
}

static int fp_is_odd(const fp_t *a) {
    fp_t v;
    fp_from_mont(&v, a);
    return (int)(v.d[0] & 1);
}

/* ---------------------------------------------------------------- fp2 -- */

static const fp2_t *FP2_P_FROB_V = (const fp2_t *)FB_FROB_V;
static const fp2_t *FP2_P_FROB_V2 = (const fp2_t *)FB_FROB_V2;
static const fp2_t *FP2_P_FROB_W = (const fp2_t *)FB_FROB_W;

static inline void fp2_zero(fp2_t *r) { r->c0 = FP_ZERO; r->c1 = FP_ZERO; }
static inline void fp2_one(fp2_t *r) {
    memcpy(r->c0.d, FB_R1, sizeof r->c0.d);
    r->c1 = FP_ZERO;
}
static inline int fp2_is_zero(const fp2_t *a) { return fp_is_zero(&a->c0) && fp_is_zero(&a->c1); }
static inline int fp2_equal(const fp2_t *a, const fp2_t *b) {
    return fp_equal(&a->c0, &b->c0) && fp_equal(&a->c1, &b->c1);
}
static inline void fp2_add(fp2_t *r, const fp2_t *a, const fp2_t *b) {
    fp_add(&r->c0, &a->c0, &b->c0);
    fp_add(&r->c1, &a->c1, &b->c1);
}
static inline void fp2_sub(fp2_t *r, const fp2_t *a, const fp2_t *b) {
    fp_sub(&r->c0, &a->c0, &b->c0);
    fp_sub(&r->c1, &a->c1, &b->c1);
}
static inline void fp2_neg(fp2_t *r, const fp2_t *a) {
    fp_neg(&r->c0, &a->c0);
    fp_neg(&r->c1, &a->c1);
}
static inline void fp2_dbl(fp2_t *r, const fp2_t *a) { fp2_add(r, a, a); }
static inline void fp2_conj(fp2_t *r, const fp2_t *a) {
    r->c0 = a->c0;
    fp_neg(&r->c1, &a->c1);
}

/* Karatsuba: 3 fp muls */
static void fp2_mul(fp2_t *r, const fp2_t *a, const fp2_t *b) {
    fp_t t0, t1, s0, s1, m;
    fp_mul(&t0, &a->c0, &b->c0);
    fp_mul(&t1, &a->c1, &b->c1);
    fp_add(&s0, &a->c0, &a->c1);
    fp_add(&s1, &b->c0, &b->c1);
    fp_mul(&m, &s0, &s1);
    fp_sub(&m, &m, &t0);
    fp_sub(&m, &m, &t1);
    fp_sub(&r->c0, &t0, &t1);
    r->c1 = m;
}

static void fp2_sqr(fp2_t *r, const fp2_t *a) {
    /* (a0+a1)(a0-a1) + 2 a0 a1 u */
    fp_t s, d, m;
    fp_add(&s, &a->c0, &a->c1);
    fp_sub(&d, &a->c0, &a->c1);
    fp_mul(&m, &a->c0, &a->c1);
    fp_mul(&r->c0, &s, &d);
    fp_dbl(&r->c1, &m);
}

static void fp2_mul_fp(fp2_t *r, const fp2_t *a, const fp_t *k) {
    fp_mul(&r->c0, &a->c0, k);
    fp_mul(&r->c1, &a->c1, k);
}

static void fp2_inv(fp2_t *r, const fp2_t *a) {
    fp_t n0, n1, norm, ninv;
    fp_sqr(&n0, &a->c0);
    fp_sqr(&n1, &a->c1);
    fp_add(&norm, &n0, &n1);
    fp_inv(&ninv, &norm);
    fp_mul(&r->c0, &a->c0, &ninv);
    fp_t t;
    fp_mul(&t, &a->c1, &ninv);
    fp_neg(&r->c1, &t);
}

/* xi = 1 + u multiplication (Fq6 nonresidue) */
static void fp2_mul_xi(fp2_t *r, const fp2_t *a) {
    fp_t t0, t1;
    fp_sub(&t0, &a->c0, &a->c1);
    fp_add(&t1, &a->c0, &a->c1);
    r->c0 = t0;
    r->c1 = t1;
}

static void fp2_pow(fp2_t *r, const fp2_t *a, const uint64_t e[6]) {
    fp2_t result, base = *a;
    fp2_one(&result);
    int top = 5;
    while (top >= 0 && e[top] == 0) top--;
    if (top < 0) { *r = result; return; }
    int bit = 63;
    while (!((e[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int j = (i == top ? bit : 63); j >= 0; j--) {
            fp2_sqr(&result, &result);
            if ((e[i] >> j) & 1) fp2_mul(&result, &result, &base);
        }
    }
    *r = result;
}

static int fp2_is_square(const fp2_t *a) {
    if (fp2_is_zero(a)) return 1;
    fp_t n0, n1, norm, leg;
    fp_sqr(&n0, &a->c0);
    fp_sqr(&n1, &a->c1);
    fp_add(&norm, &n0, &n1);
    fp_pow(&leg, &norm, FB_P_MINUS_1_DIV_2);
    fp_t one; memcpy(one.d, FB_R1, sizeof one.d);
    return fp_equal(&leg, &one);
}

/* complex-extension sqrt for p % 4 == 3 (oracle Fq2.sqrt) */
static int fp2_sqrt(fp2_t *r, const fp2_t *a) {
    if (fp2_is_zero(a)) { fp2_zero(r); return 1; }
    fp2_t a1, alpha, x0, cand;
    fp2_pow(&a1, a, FB_P_MINUS_3_DIV_4);
    fp2_sqr(&alpha, &a1);
    fp2_mul(&alpha, &alpha, a);
    fp2_mul(&x0, &a1, a);
    fp2_t minus_one;
    fp2_one(&minus_one);
    fp_t z = FP_ZERO;
    fp_sub(&minus_one.c0, &z, &minus_one.c0); /* -1 */
    if (fp2_equal(&alpha, &minus_one)) {
        /* cand = i * x0 = (-x0.c1, x0.c0) */
        fp_neg(&cand.c0, &x0.c1);
        cand.c1 = x0.c0;
    } else {
        fp2_t b, one;
        fp2_one(&one);
        fp2_add(&b, &alpha, &one);
        fp2_pow(&b, &b, FB_P_MINUS_1_DIV_2);
        fp2_mul(&cand, &b, &x0);
    }
    fp2_t chk;
    fp2_sqr(&chk, &cand);
    if (!fp2_equal(&chk, a)) return 0;
    *r = cand;
    return 1;
}

/* RFC 9380 sgn0 for m=2 */
static int fp2_sgn0(const fp2_t *a) {
    int sign0 = fp_is_odd(&a->c0);
    int zero0 = fp_is_zero(&a->c0);
    int sign1 = fp_is_odd(&a->c1);
    return sign0 | (zero0 & sign1);
}

/* lexicographic greater for G2 y sign (c1 first, then c0) */
static int fp2_is_lex_greater(const fp2_t *a) {
    if (!fp_is_zero(&a->c1)) return fp_is_lex_greater(&a->c1);
    return fp_is_lex_greater(&a->c0);
}

/* ---------------------------------------------------------------- fp6 -- */

static void fp6_zero(fp6_t *r) { fp2_zero(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }
static void fp6_one(fp6_t *r) { fp2_one(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }
static int fp6_is_zero(const fp6_t *a) {
    return fp2_is_zero(&a->c0) && fp2_is_zero(&a->c1) && fp2_is_zero(&a->c2);
}
static void fp6_add(fp6_t *r, const fp6_t *a, const fp6_t *b) {
    fp2_add(&r->c0, &a->c0, &b->c0);
    fp2_add(&r->c1, &a->c1, &b->c1);
    fp2_add(&r->c2, &a->c2, &b->c2);
}
static void fp6_sub(fp6_t *r, const fp6_t *a, const fp6_t *b) {
    fp2_sub(&r->c0, &a->c0, &b->c0);
    fp2_sub(&r->c1, &a->c1, &b->c1);
    fp2_sub(&r->c2, &a->c2, &b->c2);
}
static void fp6_neg(fp6_t *r, const fp6_t *a) {
    fp2_neg(&r->c0, &a->c0);
    fp2_neg(&r->c1, &a->c1);
    fp2_neg(&r->c2, &a->c2);
}

/* Devegili et al. interleaved Karatsuba (6 fp2 muls) */
static void fp6_mul(fp6_t *r, const fp6_t *a, const fp6_t *b) {
    fp2_t v0, v1, v2, t0, t1, t2, s;
    fp2_mul(&v0, &a->c0, &b->c0);
    fp2_mul(&v1, &a->c1, &b->c1);
    fp2_mul(&v2, &a->c2, &b->c2);
    /* c0 = v0 + xi((a1+a2)(b1+b2) - v1 - v2) */
    fp2_add(&t0, &a->c1, &a->c2);
    fp2_add(&t1, &b->c1, &b->c2);
    fp2_mul(&s, &t0, &t1);
    fp2_sub(&s, &s, &v1);
    fp2_sub(&s, &s, &v2);
    fp2_mul_xi(&s, &s);
    fp2_add(&t2, &s, &v0); /* new c0 */
    /* c1 = (a0+a1)(b0+b1) - v0 - v1 + xi v2 */
    fp2_t c1;
    fp2_add(&t0, &a->c0, &a->c1);
    fp2_add(&t1, &b->c0, &b->c1);
    fp2_mul(&c1, &t0, &t1);
    fp2_sub(&c1, &c1, &v0);
    fp2_sub(&c1, &c1, &v1);
    fp2_mul_xi(&s, &v2);
    fp2_add(&c1, &c1, &s);
    /* c2 = (a0+a2)(b0+b2) - v0 - v2 + v1 */
    fp2_t c2;
    fp2_add(&t0, &a->c0, &a->c2);
    fp2_add(&t1, &b->c0, &b->c2);
    fp2_mul(&c2, &t0, &t1);
    fp2_sub(&c2, &c2, &v0);
    fp2_sub(&c2, &c2, &v2);
    fp2_add(&c2, &c2, &v1);
    r->c0 = t2;
    r->c1 = c1;
    r->c2 = c2;
}

static void fp6_sqr(fp6_t *r, const fp6_t *a) { fp6_mul(r, a, a); }

/* multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1) */
static void fp6_mul_by_v(fp6_t *r, const fp6_t *a) {
    fp2_t t;
    fp2_mul_xi(&t, &a->c2);
    r->c2 = a->c1;
    r->c1 = a->c0;
    r->c0 = t;
}

static void fp6_inv(fp6_t *r, const fp6_t *a) {
    fp2_t c0, c1, c2, t0, t1, t;
    /* c0 = a0^2 - xi a1 a2 */
    fp2_sqr(&c0, &a->c0);
    fp2_mul(&t0, &a->c1, &a->c2);
    fp2_mul_xi(&t0, &t0);
    fp2_sub(&c0, &c0, &t0);
    /* c1 = xi a2^2 - a0 a1 */
    fp2_sqr(&c1, &a->c2);
    fp2_mul_xi(&c1, &c1);
    fp2_mul(&t0, &a->c0, &a->c1);
    fp2_sub(&c1, &c1, &t0);
    /* c2 = a1^2 - a0 a2 */
    fp2_sqr(&c2, &a->c1);
    fp2_mul(&t0, &a->c0, &a->c2);
    fp2_sub(&c2, &c2, &t0);
    /* t = a0 c0 + xi (a1 c2 + a2 c1) */
    fp2_mul(&t0, &a->c1, &c2);
    fp2_mul(&t1, &a->c2, &c1);
    fp2_add(&t0, &t0, &t1);
    fp2_mul_xi(&t0, &t0);
    fp2_mul(&t, &a->c0, &c0);
    fp2_add(&t, &t, &t0);
    fp2_inv(&t, &t);
    fp2_mul(&r->c0, &c0, &t);
    fp2_mul(&r->c1, &c1, &t);
    fp2_mul(&r->c2, &c2, &t);
}

static void fp6_frobenius(fp6_t *r, const fp6_t *a) {
    fp2_t t;
    fp2_conj(&r->c0, &a->c0);
    fp2_conj(&t, &a->c1);
    fp2_mul(&r->c1, &t, FP2_P_FROB_V);
    fp2_conj(&t, &a->c2);
    fp2_mul(&r->c2, &t, FP2_P_FROB_V2);
}

/* --------------------------------------------------------------- fp12 -- */

static void fp12_one(fp12_t *r) { fp6_one(&r->c0); fp6_zero(&r->c1); }
static int fp12_is_one(const fp12_t *a) {
    fp12_t one;
    fp12_one(&one);
    if (!fp6_is_zero(&a->c1)) return 0;
    return fp2_equal(&a->c0.c0, &one.c0.c0) && fp2_is_zero(&a->c0.c1) && fp2_is_zero(&a->c0.c2);
}

static void fp12_mul(fp12_t *r, const fp12_t *a, const fp12_t *b) {
    fp6_t v0, v1, t0, t1;
    fp6_mul(&v0, &a->c0, &b->c0);
    fp6_mul(&v1, &a->c1, &b->c1);
    /* c1 = (a0+a1)(b0+b1) - v0 - v1 */
    fp6_add(&t0, &a->c0, &a->c1);
    fp6_add(&t1, &b->c0, &b->c1);
    fp6_mul(&t0, &t0, &t1);
    fp6_sub(&t0, &t0, &v0);
    fp6_sub(&t0, &t0, &v1);
    /* c0 = v0 + v*v1 */
    fp6_mul_by_v(&t1, &v1);
    fp6_add(&r->c0, &v0, &t1);
    r->c1 = t0;
}

static void fp12_sqr(fp12_t *r, const fp12_t *a) { fp12_mul(r, a, a); }

static void fp12_conj(fp12_t *r, const fp12_t *a) {
    r->c0 = a->c0;
    fp6_neg(&r->c1, &a->c1);
}

static void fp12_inv(fp12_t *r, const fp12_t *a) {
    /* (a0 + a1 w)^-1 = (a0 - a1 w) / (a0^2 - v a1^2) */
    fp6_t t0, t1;
    fp6_sqr(&t0, &a->c0);
    fp6_sqr(&t1, &a->c1);
    fp6_mul_by_v(&t1, &t1);
    fp6_sub(&t0, &t0, &t1);
    fp6_inv(&t0, &t0);
    fp6_mul(&r->c0, &a->c0, &t0);
    fp6_mul(&t1, &a->c1, &t0);
    fp6_neg(&r->c1, &t1);
}

static void fp12_frobenius(fp12_t *r, const fp12_t *a) {
    fp6_t t;
    fp6_frobenius(&r->c0, &a->c0);
    fp6_frobenius(&t, &a->c1);
    fp2_mul(&r->c1.c0, &t.c0, FP2_P_FROB_W);
    fp2_mul(&r->c1.c1, &t.c1, FP2_P_FROB_W);
    fp2_mul(&r->c1.c2, &t.c2, FP2_P_FROB_W);
}

/* f^|z| by plain square-and-multiply over the 64-bit parameter;
 * then conjugate (z < 0, cyclotomic inverse = conjugate). */
static void fp12_pow_x(fp12_t *r, const fp12_t *a) {
    fp12_t result = *a; /* leading bit consumed */
    for (int bit = 62; bit >= 0; bit--) {
        fp12_sqr(&result, &result);
        if ((FB_X_ABS >> bit) & 1) fp12_mul(&result, &result, a);
    }
    fp12_conj(r, &result); /* negative parameter */
}

/* f^(3 * (p^12-1)/r) via easy part + BLS12 x-chain (ops/pairing.py
 * final_exponentiation; the cube is harmless for verdicts). */
static void fp12_final_exp(fp12_t *r, const fp12_t *f) {
    fp12_t f1, inv, m, y0, y1, y2, y3, t, t2;
    /* easy: f^(p^6-1) = conj(f) * inv(f); then ^(p^2+1) */
    fp12_conj(&f1, f);
    fp12_inv(&inv, f);
    fp12_mul(&f1, &f1, &inv);
    fp12_frobenius(&m, &f1);
    fp12_frobenius(&m, &m);
    fp12_mul(&m, &m, &f1);
    /* hard: ((x-1)^2 (x+p) (x^2+p^2-1) + 3) */
    fp12_pow_x(&y0, &m);
    fp12_conj(&t, &m);
    fp12_mul(&y0, &y0, &t); /* m^(x-1) */
    fp12_pow_x(&y1, &y0);
    fp12_conj(&t, &y0);
    fp12_mul(&y1, &y1, &t); /* m^((x-1)^2) */
    fp12_pow_x(&y2, &y1);
    fp12_frobenius(&t, &y1);
    fp12_mul(&y2, &y2, &t); /* ^(x+p) */
    fp12_pow_x(&y3, &y2);
    fp12_pow_x(&y3, &y3);
    fp12_frobenius(&t, &y2);
    fp12_frobenius(&t, &t);
    fp12_mul(&y3, &y3, &t);
    fp12_conj(&t, &y2);
    fp12_mul(&y3, &y3, &t); /* ^(x^2+p^2-1) */
    fp12_sqr(&t2, &m);
    fp12_mul(&t2, &t2, &m); /* m^3 */
    fp12_mul(r, &y3, &t2);
}

/* ------------------------------------------------------------ G1 / G2 -- */

static void g1_infinity(g1_t *r) {
    memcpy(r->x.d, FB_R1, sizeof r->x.d);
    memcpy(r->y.d, FB_R1, sizeof r->y.d);
    r->z = FP_ZERO;
}
static int g1_is_infinity(const g1_t *a) { return fp_is_zero(&a->z); }

static void g1_double(g1_t *r, const g1_t *p) {
    if (g1_is_infinity(p)) { *r = *p; return; }
    fp_t a, b, c, d, e, f, t, x3, y3, z3;
    fp_sqr(&a, &p->x);
    fp_sqr(&b, &p->y);
    fp_sqr(&c, &b);
    fp_add(&t, &p->x, &b);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &a);
    fp_sub(&t, &t, &c);
    fp_dbl(&d, &t);
    fp_dbl(&e, &a);
    fp_add(&e, &e, &a);
    fp_sqr(&f, &e);
    fp_sub(&x3, &f, &d);
    fp_sub(&x3, &x3, &d);
    fp_sub(&t, &d, &x3);
    fp_mul(&y3, &e, &t);
    fp_dbl(&c, &c); fp_dbl(&c, &c); fp_dbl(&c, &c); /* 8C */
    fp_sub(&y3, &y3, &c);
    fp_mul(&z3, &p->y, &p->z);
    fp_dbl(&z3, &z3);
    r->x = x3; r->y = y3; r->z = z3;
}

static void g1_add(g1_t *r, const g1_t *p, const g1_t *q) {
    if (g1_is_infinity(p)) { *r = *q; return; }
    if (g1_is_infinity(q)) { *r = *p; return; }
    fp_t z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, x3, y3, z3;
    fp_sqr(&z1z1, &p->z);
    fp_sqr(&z2z2, &q->z);
    fp_mul(&u1, &p->x, &z2z2);
    fp_mul(&u2, &q->x, &z1z1);
    fp_mul(&s1, &p->y, &q->z); fp_mul(&s1, &s1, &z2z2);
    fp_mul(&s2, &q->y, &p->z); fp_mul(&s2, &s2, &z1z1);
    if (fp_equal(&u1, &u2)) {
        if (fp_equal(&s1, &s2)) { g1_double(r, p); return; }
        g1_infinity(r); return;
    }
    fp_sub(&h, &u2, &u1);
    fp_dbl(&i, &h);
    fp_sqr(&i, &i);
    fp_mul(&j, &h, &i);
    fp_sub(&rr, &s2, &s1);
    fp_dbl(&rr, &rr);
    fp_mul(&v, &u1, &i);
    fp_sqr(&x3, &rr);
    fp_sub(&x3, &x3, &j);
    fp_sub(&x3, &x3, &v);
    fp_sub(&x3, &x3, &v);
    fp_sub(&t, &v, &x3);
    fp_mul(&y3, &rr, &t);
    fp_mul(&t, &s1, &j);
    fp_dbl(&t, &t);
    fp_sub(&y3, &y3, &t);
    fp_add(&z3, &p->z, &q->z);
    fp_sqr(&z3, &z3);
    fp_sub(&z3, &z3, &z1z1);
    fp_sub(&z3, &z3, &z2z2);
    fp_mul(&z3, &z3, &h);
    r->x = x3; r->y = y3; r->z = z3;
}

static void g1_neg(g1_t *r, const g1_t *p) {
    r->x = p->x;
    fp_neg(&r->y, &p->y);
    r->z = p->z;
}

/* scalar given as 4 LE limbs (up to 256 bits) */
static void g1_mul(g1_t *r, const g1_t *p, const uint64_t e[4]) {
    g1_t acc;
    g1_infinity(&acc);
    int top = 3;
    while (top >= 0 && e[top] == 0) top--;
    if (top < 0) { *r = acc; return; }
    int bit = 63;
    while (!((e[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int j = (i == top ? bit : 63); j >= 0; j--) {
            g1_double(&acc, &acc);
            if ((e[i] >> j) & 1) g1_add(&acc, &acc, p);
        }
    }
    *r = acc;
}

/* -> affine; returns 0 for infinity */
static int g1_to_affine(fp_t *x, fp_t *y, const g1_t *p) {
    if (g1_is_infinity(p)) return 0;
    fp_t zi, zi2, zi3;
    fp_inv(&zi, &p->z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(x, &p->x, &zi2);
    fp_mul(y, &p->y, &zi3);
    return 1;
}

static int g1_on_curve(const fp_t *x, const fp_t *y) {
    fp_t l, rr, b;
    fp_sqr(&l, y);
    fp_sqr(&rr, x);
    fp_mul(&rr, &rr, x);
    memcpy(b.d, FB_B1, sizeof b.d);
    fp_add(&rr, &rr, &b);
    return fp_equal(&l, &rr);
}

static int g1_equal(const g1_t *a, const g1_t *b) {
    int ia = g1_is_infinity(a), ib = g1_is_infinity(b);
    if (ia || ib) return ia && ib;
    /* cross-multiplied jacobian comparison */
    fp_t za2, zb2, za3, zb3, t0, t1;
    fp_sqr(&za2, &a->z);
    fp_sqr(&zb2, &b->z);
    fp_mul(&t0, &a->x, &zb2);
    fp_mul(&t1, &b->x, &za2);
    if (!fp_equal(&t0, &t1)) return 0;
    fp_mul(&za3, &za2, &a->z);
    fp_mul(&zb3, &zb2, &b->z);
    fp_mul(&t0, &a->y, &zb3);
    fp_mul(&t1, &b->y, &za3);
    return fp_equal(&t0, &t1);
}

/* G1 subgroup check via the sigma endomorphism: sigma(P) == [z^2-1]P */
static int g1_subgroup_check(const g1_t *p) {
    if (g1_is_infinity(p)) return 1;
    fp_t ax, ay;
    g1_to_affine(&ax, &ay, p);
    g1_t sigma;
    fp_t beta; memcpy(beta.d, FB_BETA, sizeof beta.d);
    fp_mul(&sigma.x, &ax, &beta);
    sigma.y = ay;
    memcpy(sigma.z.d, FB_R1, sizeof sigma.z.d);
    /* z^2 - 1 with z = -|x|: z^2 - 1 = x^2 - 1 */
    unsigned __int128 x2 = (unsigned __int128)FB_X_ABS * FB_X_ABS - 1;
    uint64_t e[4] = {(uint64_t)x2, (uint64_t)(x2 >> 64), 0, 0};
    g1_t zp;
    g1_mul(&zp, p, e);
    return g1_equal(&sigma, &zp);
}

/* G2 mirrors of all of the above */

static void g2_infinity(g2_t *r) {
    fp2_one(&r->x);
    fp2_one(&r->y);
    fp2_zero(&r->z);
}
static int g2_is_infinity(const g2_t *a) { return fp2_is_zero(&a->z); }

static void g2_double(g2_t *r, const g2_t *p) {
    if (g2_is_infinity(p)) { *r = *p; return; }
    fp2_t a, b, c, d, e, f, t, x3, y3, z3;
    fp2_sqr(&a, &p->x);
    fp2_sqr(&b, &p->y);
    fp2_sqr(&c, &b);
    fp2_add(&t, &p->x, &b);
    fp2_sqr(&t, &t);
    fp2_sub(&t, &t, &a);
    fp2_sub(&t, &t, &c);
    fp2_dbl(&d, &t);
    fp2_dbl(&e, &a);
    fp2_add(&e, &e, &a);
    fp2_sqr(&f, &e);
    fp2_sub(&x3, &f, &d);
    fp2_sub(&x3, &x3, &d);
    fp2_sub(&t, &d, &x3);
    fp2_mul(&y3, &e, &t);
    fp2_dbl(&c, &c); fp2_dbl(&c, &c); fp2_dbl(&c, &c);
    fp2_sub(&y3, &y3, &c);
    fp2_mul(&z3, &p->y, &p->z);
    fp2_dbl(&z3, &z3);
    r->x = x3; r->y = y3; r->z = z3;
}

static void g2_add(g2_t *r, const g2_t *p, const g2_t *q) {
    if (g2_is_infinity(p)) { *r = *q; return; }
    if (g2_is_infinity(q)) { *r = *p; return; }
    fp2_t z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, x3, y3, z3;
    fp2_sqr(&z1z1, &p->z);
    fp2_sqr(&z2z2, &q->z);
    fp2_mul(&u1, &p->x, &z2z2);
    fp2_mul(&u2, &q->x, &z1z1);
    fp2_mul(&s1, &p->y, &q->z); fp2_mul(&s1, &s1, &z2z2);
    fp2_mul(&s2, &q->y, &p->z); fp2_mul(&s2, &s2, &z1z1);
    if (fp2_equal(&u1, &u2)) {
        if (fp2_equal(&s1, &s2)) { g2_double(r, p); return; }
        g2_infinity(r); return;
    }
    fp2_sub(&h, &u2, &u1);
    fp2_dbl(&i, &h);
    fp2_sqr(&i, &i);
    fp2_mul(&j, &h, &i);
    fp2_sub(&rr, &s2, &s1);
    fp2_dbl(&rr, &rr);
    fp2_mul(&v, &u1, &i);
    fp2_sqr(&x3, &rr);
    fp2_sub(&x3, &x3, &j);
    fp2_sub(&x3, &x3, &v);
    fp2_sub(&x3, &x3, &v);
    fp2_sub(&t, &v, &x3);
    fp2_mul(&y3, &rr, &t);
    fp2_mul(&t, &s1, &j);
    fp2_dbl(&t, &t);
    fp2_sub(&y3, &y3, &t);
    fp2_add(&z3, &p->z, &q->z);
    fp2_sqr(&z3, &z3);
    fp2_sub(&z3, &z3, &z1z1);
    fp2_sub(&z3, &z3, &z2z2);
    fp2_mul(&z3, &z3, &h);
    r->x = x3; r->y = y3; r->z = z3;
}

static void g2_neg(g2_t *r, const g2_t *p) {
    r->x = p->x;
    fp2_neg(&r->y, &p->y);
    r->z = p->z;
}

static void g2_mul(g2_t *r, const g2_t *p, const uint64_t e[4]) {
    g2_t acc;
    g2_infinity(&acc);
    int top = 3;
    while (top >= 0 && e[top] == 0) top--;
    if (top < 0) { *r = acc; return; }
    int bit = 63;
    while (!((e[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int j = (i == top ? bit : 63); j >= 0; j--) {
            g2_double(&acc, &acc);
            if ((e[i] >> j) & 1) g2_add(&acc, &acc, p);
        }
    }
    *r = acc;
}

/* branchless r = bit ? a : b over the 36 limbs (3 fp2 = 6 fp x 6 limbs)
 * of a jacobian g2 point */
static void g2_csel(g2_t *r, const g2_t *a, const g2_t *b, uint64_t bit) {
    uint64_t mask = (uint64_t)0 - (bit & 1);
    const uint64_t *pa = (const uint64_t *)a;
    const uint64_t *pb = (const uint64_t *)b;
    uint64_t *pr = (uint64_t *)r;
    for (size_t i = 0; i < sizeof(g2_t) / sizeof(uint64_t); i++)
        pr[i] = (pa[i] & mask) | (pb[i] & ~mask);
}

/* out = e + r (+ r again, branchlessly, while bit 255 is still clear).
 * For e in [1, r): out == e (mod r), out < 2^256, and bit 255 is ALWAYS
 * set — so a fixed 256-bit ladder can start from a known top bit and
 * never touch the infinity point, independent of e.  (r ~ 0.45 * 2^256:
 * e + r never carries out of 4 limbs, and the second add only happens
 * when e + r < 2^255, which bounds e + 2r < 2^256.) */
static void scalar_fix256(uint64_t out[4], const uint64_t e[4]) {
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (unsigned __int128)e[i] + FB_ORDER[i];
        out[i] = (uint64_t)c;
        c >>= 64;
    }
    uint64_t mask = (uint64_t)0 - (1 ^ (out[3] >> 63));
    c = 0;
    for (int i = 0; i < 4; i++) {
        c += (unsigned __int128)out[i] + (FB_ORDER[i] & mask);
        out[i] = (uint64_t)c;
        c >>= 64;
    }
}

/* Scalar mult with a UNIFORM operation sequence: fixed-length ladder
 * (scalar_fix256 pins the top bit), one double + one add + one branchless
 * select per bit — unlike g2_mul above, no per-bit branch and no
 * scalar-dependent iteration count, so the timing/branch trace does not
 * encode the secret scalar.  Residual caveats, stated honestly: the
 * exceptional-case branches inside g2_add (acc == +-p, i.e. a ladder
 * prefix ~ +-1 mod r) fire with probability ~2^-254 for uniform secrets,
 * and the Montgomery fp core is data-independent in operation sequence
 * but not audited to asm level.  This is the double-and-always-add
 * discipline production signers need; the sliding g2_mul stays for
 * verification work on PUBLIC points where speed matters. */
static void g2_mul_ct(g2_t *r, const g2_t *p, const uint64_t e[4]) {
    uint64_t k[4];
    g2_t acc, sum;
    scalar_fix256(k, e);
    acc = *p; /* top bit (255) is always set */
    for (int i = 254; i >= 0; i--) {
        g2_double(&acc, &acc);
        g2_add(&sum, &acc, p);
        g2_csel(&acc, &sum, &acc, (k[i >> 6] >> (i & 63)) & 1);
    }
    *r = acc;
}

static int g2_to_affine(fp2_t *x, fp2_t *y, const g2_t *p) {
    if (g2_is_infinity(p)) return 0;
    fp2_t zi, zi2, zi3;
    fp2_inv(&zi, &p->z);
    fp2_sqr(&zi2, &zi);
    fp2_mul(&zi3, &zi2, &zi);
    fp2_mul(x, &p->x, &zi2);
    fp2_mul(y, &p->y, &zi3);
    return 1;
}

static int g2_on_curve(const fp2_t *x, const fp2_t *y) {
    fp2_t l, rr;
    const fp2_t *b2 = (const fp2_t *)FB_B2;
    fp2_sqr(&l, y);
    fp2_sqr(&rr, x);
    fp2_mul(&rr, &rr, x);
    fp2_add(&rr, &rr, b2);
    return fp2_equal(&l, &rr);
}

static int g2_equal(const g2_t *a, const g2_t *b) {
    int ia = g2_is_infinity(a), ib = g2_is_infinity(b);
    if (ia || ib) return ia && ib;
    fp2_t za2, zb2, za3, zb3, t0, t1;
    fp2_sqr(&za2, &a->z);
    fp2_sqr(&zb2, &b->z);
    fp2_mul(&t0, &a->x, &zb2);
    fp2_mul(&t1, &b->x, &za2);
    if (!fp2_equal(&t0, &t1)) return 0;
    fp2_mul(&za3, &za2, &a->z);
    fp2_mul(&zb3, &zb2, &b->z);
    fp2_mul(&t0, &a->y, &zb3);
    fp2_mul(&t1, &b->y, &za3);
    return fp2_equal(&t0, &t1);
}

/* psi endomorphism on affine coords (curve.py psi) */
static void g2_psi_affine(fp2_t *rx, fp2_t *ry, const fp2_t *x, const fp2_t *y) {
    fp2_t t;
    fp2_conj(&t, x);
    fp2_mul(rx, &t, (const fp2_t *)FB_PSI_CX);
    fp2_conj(&t, y);
    fp2_mul(ry, &t, (const fp2_t *)FB_PSI_CY);
}

static void g2_psi(g2_t *r, const g2_t *p) {
    if (g2_is_infinity(p)) { *r = *p; return; }
    fp2_t x, y, px, py;
    g2_to_affine(&x, &y, p);
    g2_psi_affine(&px, &py, &x, &y);
    r->x = px;
    r->y = py;
    fp2_one(&r->z);
}

/* G2 subgroup: psi(P) == [z]P = -[|z|]P */
static int g2_subgroup_check(const g2_t *p) {
    if (g2_is_infinity(p)) return 1;
    g2_t psi_p, zp;
    g2_psi(&psi_p, p);
    uint64_t e[4] = {FB_X_ABS, 0, 0, 0};
    g2_mul(&zp, p, e);
    g2_neg(&zp, &zp);
    return g2_equal(&psi_p, &zp);
}

/* Budroni-Pintore cofactor clearing:
 * h_eff P = [z^2-z-1]P + [z-1]psi(P) + psi^2([2]P), z = -|x| */
static void g2_clear_cofactor(g2_t *r, const g2_t *p) {
    /* z^2 - z - 1 = x^2 + x - 1 (positive, ~128 bits) */
    unsigned __int128 s = (unsigned __int128)FB_X_ABS * FB_X_ABS + FB_X_ABS - 1;
    uint64_t e1[4] = {(uint64_t)s, (uint64_t)(s >> 64), 0, 0};
    g2_t t1, t2, t3, psi_p, d;
    g2_mul(&t1, p, e1);
    /* [z-1]P = -[|x|+1]P */
    uint64_t e2[4] = {FB_X_ABS + 1, 0, 0, 0};
    g2_psi(&psi_p, p);
    g2_mul(&t2, &psi_p, e2);
    g2_neg(&t2, &t2);
    g2_double(&d, p);
    g2_psi(&t3, &d);
    g2_psi(&t3, &t3);
    g2_add(r, &t1, &t2);
    g2_add(r, r, &t3);
}

/* ------------------------------------------------------ decompression -- */

/* ZCash compressed format; returns 1 ok, 0 malformed/not-on-curve.
 * subgroup check is separate (callers decide). infinity -> z = 0. */
static int g1_from_compressed(g1_t *r, const uint8_t *in) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return 0;
    if (flags & 0x40) {
        if (flags != 0xC0) return 0;
        for (int i = 1; i < 48; i++) if (in[i]) return 0;
        g1_infinity(r);
        return 1;
    }
    uint8_t buf[48];
    memcpy(buf, in, 48);
    buf[0] &= 0x1F;
    fp_t x, y2, y, b;
    if (!fp_from_bytes(&x, buf)) return 0;
    fp_sqr(&y2, &x);
    fp_mul(&y2, &y2, &x);
    memcpy(b.d, FB_B1, sizeof b.d);
    fp_add(&y2, &y2, &b);
    if (!fp_sqrt(&y, &y2)) return 0;
    if (fp_is_lex_greater(&y) != !!(flags & 0x20)) fp_neg(&y, &y);
    r->x = x;
    r->y = y;
    memcpy(r->z.d, FB_R1, sizeof r->z.d);
    return 1;
}

static int g2_from_compressed(g2_t *r, const uint8_t *in) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return 0;
    if (flags & 0x40) {
        if (flags != 0xC0) return 0;
        for (int i = 1; i < 96; i++) if (in[i]) return 0;
        g2_infinity(r);
        return 1;
    }
    uint8_t buf[48];
    memcpy(buf, in, 48);
    buf[0] &= 0x1F;
    fp2_t x, y2, y;
    if (!fp_from_bytes(&x.c1, buf)) return 0;   /* c1 first on the wire */
    if (!fp_from_bytes(&x.c0, in + 48)) return 0;
    fp2_sqr(&y2, &x);
    fp2_mul(&y2, &y2, &x);
    fp2_add(&y2, &y2, (const fp2_t *)FB_B2);
    if (!fp2_sqrt(&y, &y2)) return 0;
    if (fp2_is_lex_greater(&y) != !!(flags & 0x20)) fp2_neg(&y, &y);
    r->x = x;
    r->y = y;
    fp2_one(&r->z);
    return 1;
}

/* -------------------------------------------------------------- sha256 -- */

static const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

typedef struct {
    uint32_t h[8];
    uint64_t len;
    uint8_t buf[64];
    size_t buflen;
} sha256_ctx;

static void sha256_init(sha256_ctx *c) {
    static const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, h0, sizeof h0);
    c->len = 0;
    c->buflen = 0;
}

static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha256_block(sha256_ctx *c, const uint8_t *p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3];
    uint32_t e = c->h[4], f = c->h[5], g = c->h[6], h = c->h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + SHA_K[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void sha256_update(sha256_ctx *c, const uint8_t *p, size_t n) {
    c->len += n;
    while (n) {
        if (c->buflen == 0 && n >= 64) {
            sha256_block(c, p);
            p += 64;
            n -= 64;
        } else {
            size_t take = 64 - c->buflen;
            if (take > n) take = n;
            memcpy(c->buf + c->buflen, p, take);
            c->buflen += take;
            p += take;
            n -= take;
            if (c->buflen == 64) {
                sha256_block(c, c->buf);
                c->buflen = 0;
            }
        }
    }
}

static void sha256_final(sha256_ctx *c, uint8_t out[32]) {
    uint64_t bits = c->len * 8;
    uint8_t pad = 0x80;
    sha256_update(c, &pad, 1);
    uint8_t z = 0;
    while (c->buflen != 56) sha256_update(c, &z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (8 * (7 - i)));
    sha256_update(c, lb, 8);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(c->h[i] >> 24);
        out[4 * i + 1] = (uint8_t)(c->h[i] >> 16);
        out[4 * i + 2] = (uint8_t)(c->h[i] >> 8);
        out[4 * i + 3] = (uint8_t)c->h[i];
    }
}

/* ------------------------------------------------------- hash-to-G2 ---- */

static const char DST[] = "BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_";
#define DST_LEN 43
#define HTF_L 64 /* bytes per draw */

/* expand_message_xmd for len_in_bytes = 256 (count=2, m=2, L=64) */
static void expand_message_256(uint8_t out[256], const uint8_t *msg, size_t msg_len) {
    uint8_t b0[32], bi[32];
    sha256_ctx c;
    static const uint8_t z_pad[64] = {0};
    uint8_t lib[3] = {0x01, 0x00, 0x00}; /* 256 big-endian, then i2osp(0,1) */
    uint8_t dst_prime[DST_LEN + 1];
    memcpy(dst_prime, DST, DST_LEN);
    dst_prime[DST_LEN] = DST_LEN;
    sha256_init(&c);
    sha256_update(&c, z_pad, 64);
    sha256_update(&c, msg, msg_len);
    sha256_update(&c, lib, 3);
    sha256_update(&c, dst_prime, DST_LEN + 1);
    sha256_final(&c, b0);
    uint8_t one = 1;
    sha256_init(&c);
    sha256_update(&c, b0, 32);
    sha256_update(&c, &one, 1);
    sha256_update(&c, dst_prime, DST_LEN + 1);
    sha256_final(&c, bi);
    memcpy(out, bi, 32);
    for (int i = 2; i <= 8; i++) {
        uint8_t tmp[32];
        for (int j = 0; j < 32; j++) tmp[j] = b0[j] ^ bi[j];
        uint8_t idx = (uint8_t)i;
        sha256_init(&c);
        sha256_update(&c, tmp, 32);
        sha256_update(&c, &idx, 1);
        sha256_update(&c, dst_prime, DST_LEN + 1);
        sha256_final(&c, bi);
        memcpy(out + 32 * (i - 1), bi, 32);
    }
}

/* reduce a 64-byte big-endian integer mod p into mont form */
static void fp_from_be64_reduce(fp_t *r, const uint8_t *in) {
    /* v = hi * 2^128 + lo, hi 48 bytes, lo 16 bytes:
     * process as base-2^64 digits with Montgomery-free reduction via
     * repeated (shift 64 + add) using fp arithmetic on mont values:
     * simpler: accumulate byte-by-byte: r = r*256 + byte (in mont form). */
    fp_t acc = FP_ZERO, t256, byte_v;
    fp_t r256 = FP_ZERO;
    r256.d[0] = 256;
    fp_to_mont(&t256, &r256);
    for (int i = 0; i < 64; i++) {
        fp_mul(&acc, &acc, &t256);
        fp_t bv = FP_ZERO;
        bv.d[0] = in[i];
        fp_to_mont(&byte_v, &bv);
        fp_add(&acc, &acc, &byte_v);
    }
    *r = acc;
}

/* g'(x) = x^3 + A'x + B' on the isogenous curve */
static void sswu_gprime(fp2_t *r, const fp2_t *x) {
    fp2_t t, ax;
    fp2_sqr(&t, x);
    fp2_mul(&t, &t, x);
    fp2_mul(&ax, (const fp2_t *)FB_ISO_A, x);
    fp2_add(&t, &t, &ax);
    fp2_add(r, &t, (const fp2_t *)FB_ISO_B);
}

/* simplified SWU onto E' (oracle map_to_curve_sswu) */
static void sswu_map(fp2_t *xo, fp2_t *yo, const fp2_t *u) {
    const fp2_t *Z = (const fp2_t *)FB_SSWU_Z;
    const fp2_t *A = (const fp2_t *)FB_ISO_A;
    const fp2_t *B = (const fp2_t *)FB_ISO_B;
    fp2_t u2, u4, z2, tv1, x1, gx1, one;
    fp2_one(&one);
    fp2_sqr(&u2, u);
    fp2_sqr(&u4, &u2);
    fp2_sqr(&z2, Z);
    fp2_mul(&tv1, &z2, &u4);
    fp2_t zu2;
    fp2_mul(&zu2, Z, &u2);
    fp2_add(&tv1, &tv1, &zu2);
    if (fp2_is_zero(&tv1)) {
        fp2_t za, zai;
        fp2_mul(&za, Z, A);
        fp2_inv(&zai, &za);
        fp2_mul(&x1, B, &zai);
    } else {
        fp2_t negb, ainv, inv1, s;
        fp2_neg(&negb, B);
        fp2_inv(&ainv, A);
        fp2_inv(&inv1, &tv1);
        fp2_add(&s, &one, &inv1);
        fp2_mul(&x1, &negb, &ainv);
        fp2_mul(&x1, &x1, &s);
    }
    sswu_gprime(&gx1, &x1);
    fp2_t x, y;
    if (fp2_is_square(&gx1)) {
        x = x1;
        fp2_sqrt(&y, &gx1);
    } else {
        fp2_t gx2;
        fp2_mul(&x, &zu2, &x1);
        sswu_gprime(&gx2, &x);
        fp2_sqrt(&y, &gx2);
    }
    if (fp2_sgn0(u) != fp2_sgn0(&y)) fp2_neg(&y, &y);
    *xo = x;
    *yo = y;
}

static void eval_poly(fp2_t *r, const uint64_t coeffs[][2][6], int n, const fp2_t *x) {
    fp2_t acc;
    fp2_zero(&acc);
    for (int i = n - 1; i >= 0; i--) {
        fp2_mul(&acc, &acc, x);
        fp2_add(&acc, &acc, (const fp2_t *)coeffs[i]);
    }
    *r = acc;
}

/* 3-isogeny E' -> E2 */
static void iso_map(fp2_t *xo, fp2_t *yo, const fp2_t *x, const fp2_t *y) {
    fp2_t xn, xd, yn, yd, xdi, ydi;
    eval_poly(&xn, FB_K1, 4, x);
    eval_poly(&xd, FB_K2, 3, x);
    eval_poly(&yn, FB_K3, 4, x);
    eval_poly(&yd, FB_K4, 4, x);
    fp2_inv(&xdi, &xd);
    fp2_inv(&ydi, &yd);
    fp2_mul(xo, &xn, &xdi);
    fp2_mul(yo, y, &yn);
    fp2_mul(yo, yo, &ydi);
}

/* full hash_to_g2 (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_) */
static void hash_to_g2(g2_t *r, const uint8_t *msg, size_t msg_len) {
    uint8_t uniform[256];
    expand_message_256(uniform, msg, msg_len);
    fp2_t u0, u1;
    fp_from_be64_reduce(&u0.c0, uniform);
    fp_from_be64_reduce(&u0.c1, uniform + 64);
    fp_from_be64_reduce(&u1.c0, uniform + 128);
    fp_from_be64_reduce(&u1.c1, uniform + 192);
    fp2_t x0, y0, x1, y1, xm, ym;
    g2_t q0, q1, q;
    sswu_map(&x0, &y0, &u0);
    iso_map(&xm, &ym, &x0, &y0);
    q0.x = xm; q0.y = ym; fp2_one(&q0.z);
    sswu_map(&x1, &y1, &u1);
    iso_map(&xm, &ym, &x1, &y1);
    q1.x = xm; q1.y = ym; fp2_one(&q1.z);
    g2_add(&q, &q0, &q1);
    g2_clear_cofactor(r, &q);
}

/* ------------------------------------------------------------ pairing -- */

/* line value as sparse fp12: (c0 + c1 v) + (c2 v) w */
static void line_to_fp12(fp12_t *r, const fp2_t *c0, const fp2_t *c1, const fp2_t *c2) {
    r->c0.c0 = *c0;
    r->c0.c1 = *c1;
    fp2_zero(&r->c0.c2);
    fp2_zero(&r->c1.c0);
    r->c1.c1 = *c2;
    fp2_zero(&r->c1.c2);
}

/* doubling step with tangent line (ops/pairing.py _dbl_step):
 * line scaled by 2YZ^3 (subfield factor, killed by final exp):
 *   c0 = 3X^3 - 2Y^2; c1 = -3X^2 Z^2 xp; c2 = 2YZ^3 yp */
static void miller_dbl_step(g2_t *t, fp12_t *line, const fp_t *xp, const fp_t *yp) {
    fp2_t x2, y2, z2, yz, x2_3, x3_3, c1r, yz3, c0, c1, c2, t2;
    fp2_sqr(&x2, &t->x);
    fp2_sqr(&y2, &t->y);
    fp2_sqr(&z2, &t->z);
    fp2_mul(&yz, &t->y, &t->z);
    fp2_dbl(&x2_3, &x2);
    fp2_add(&x2_3, &x2_3, &x2);
    fp2_mul(&x3_3, &x2_3, &t->x);
    fp2_mul(&c1r, &x2_3, &z2);
    fp2_mul(&yz3, &yz, &z2);
    fp2_dbl(&t2, &y2);
    fp2_sub(&c0, &x3_3, &t2);
    fp2_mul_fp(&c1, &c1r, xp);
    fp2_neg(&c1, &c1);
    fp2_dbl(&yz3, &yz3);
    fp2_mul_fp(&c2, &yz3, yp);
    line_to_fp12(line, &c0, &c1, &c2);
    g2_double(t, t);
}

/* addition step with the affine loop point Q (ops/pairing.py _add_step):
 * line scaled by Z*H: c0 = theta xq - yq Z H; c1 = -theta xp; c2 = Z H yp */
static void miller_add_step(g2_t *t, fp12_t *line, const fp2_t *xq, const fp2_t *yq,
                            const fp_t *xp, const fp_t *yp) {
    fp2_t zz, zzz, u2, s2, theta, h, zh, theta_xq, yq_zh, c0, c1, c2;
    fp2_sqr(&zz, &t->z);
    fp2_mul(&zzz, &zz, &t->z);
    fp2_mul(&u2, xq, &zz);
    fp2_mul(&s2, yq, &zzz);
    fp2_sub(&theta, &t->y, &s2);
    fp2_sub(&h, &t->x, &u2);
    fp2_mul(&zh, &t->z, &h);
    fp2_mul(&theta_xq, &theta, xq);
    fp2_mul(&yq_zh, yq, &zh);
    fp2_sub(&c0, &theta_xq, &yq_zh);
    fp2_mul_fp(&c1, &theta, xp);
    fp2_neg(&c1, &c1);
    fp2_mul_fp(&c2, &zh, yp);
    line_to_fp12(line, &c0, &c1, &c2);
    /* mixed add T + Q with doubled r (device convention) */
    fp2_t hm, rm, hh, r2, ii, j, v, zhm, x3, y3, z3, tmp;
    fp2_sub(&hm, &u2, &t->x);
    fp2_sub(&rm, &s2, &t->y);
    fp2_dbl(&rm, &rm);
    fp2_sqr(&hh, &hm);
    fp2_sqr(&r2, &rm);
    fp2_dbl(&ii, &hh);
    fp2_dbl(&ii, &ii);
    fp2_mul(&j, &hm, &ii);
    fp2_mul(&v, &t->x, &ii);
    fp2_mul(&zhm, &t->z, &hm);
    fp2_dbl(&tmp, &v);
    fp2_add(&tmp, &tmp, &j);
    fp2_sub(&x3, &r2, &tmp);
    fp2_sub(&tmp, &v, &x3);
    fp2_mul(&y3, &rm, &tmp);
    fp2_mul(&tmp, &t->y, &j);
    fp2_dbl(&tmp, &tmp);
    fp2_sub(&y3, &y3, &tmp);
    fp2_dbl(&z3, &zhm);
    t->x = x3;
    t->y = y3;
    t->z = z3;
}

/* f *= miller(P, Q) for affine P (G1) and Q (G2); result correct up to
 * subfield factors (shared final exp handles them). */
static void miller_loop_acc(fp12_t *f, const fp_t *xp, const fp_t *yp,
                            const fp2_t *xq, const fp2_t *yq) {
    g2_t t;
    t.x = *xq;
    t.y = *yq;
    fp2_one(&t.z);
    fp12_t acc, line;
    fp12_one(&acc);
    for (int bit = 62; bit >= 0; bit--) {
        fp12_sqr(&acc, &acc);
        miller_dbl_step(&t, &line, xp, yp);
        fp12_mul(&acc, &acc, &line);
        if ((FB_X_ABS >> bit) & 1) {
            miller_add_step(&t, &line, xq, yq, xp, yp);
            fp12_mul(&acc, &acc, &line);
        }
    }
    fp12_conj(&acc, &acc); /* negative parameter */
    fp12_mul(f, f, &acc);
}

/* ------------------------------------------------------------ exports -- */

#define FB_OK 1
#define FB_FAIL 0
#define FB_MALFORMED (-1)

/* batch verify with random linear combination:
 *   e(-g1, sum c_i s_i) * prod e(c_i agg_pk_i, H(m_i)) == 1
 * pubkeys: concatenated 48-byte compressed; pk_counts[i] pubkeys belong to
 * set i (aggregated in jacobian coords, the reference's main-thread
 * aggregation, chain/bls/utils.ts:5).  msgs: n * 32.  sigs: n * 96.
 * coeffs: odd 64-bit.  Infinity pubkeys/sigs are rejected. */
int fb_batch_verify(size_t n_sets, const uint8_t *pubkeys, const uint32_t *pk_counts,
                    const uint8_t *msgs, const uint8_t *sigs, const uint64_t *coeffs) {
    if (n_sets == 0) return FB_FAIL;
    fp12_t f;
    fp12_one(&f);
    g2_t sig_acc;
    g2_infinity(&sig_acc);
    size_t pk_off = 0;
    for (size_t i = 0; i < n_sets; i++) {
        /* aggregate this set's pubkeys */
        g1_t agg;
        g1_infinity(&agg);
        uint32_t cnt = pk_counts[i];
        if (cnt == 0) return FB_MALFORMED;
        for (uint32_t k = 0; k < cnt; k++) {
            g1_t pk;
            if (!g1_from_compressed(&pk, pubkeys + 48 * (pk_off + k)))
                return FB_MALFORMED;
            if (g1_is_infinity(&pk)) return FB_MALFORMED;
            if (!g1_subgroup_check(&pk)) return FB_MALFORMED;
            g1_add(&agg, &agg, &pk);
        }
        pk_off += cnt;
        if (g1_is_infinity(&agg)) return FB_MALFORMED;
        g2_t sig;
        if (!g2_from_compressed(&sig, sigs + 96 * i)) return FB_MALFORMED;
        if (g2_is_infinity(&sig)) return FB_MALFORMED;
        if (!g2_subgroup_check(&sig)) return FB_FAIL;
        uint64_t e[4] = {coeffs[i], 0, 0, 0};
        g2_t sig_c;
        g2_mul(&sig_c, &sig, e);
        g2_add(&sig_acc, &sig_acc, &sig_c);
        g1_t pk_c;
        g1_mul(&pk_c, &agg, e);
        fp_t ax, ay;
        if (!g1_to_affine(&ax, &ay, &pk_c)) return FB_MALFORMED;
        g2_t h;
        hash_to_g2(&h, msgs + 32 * i, 32);
        fp2_t hx, hy;
        if (!g2_to_affine(&hx, &hy, &h)) return FB_MALFORMED;
        miller_loop_acc(&f, &ax, &ay, &hx, &hy);
    }
    /* (-g1, sum c_i s_i) */
    if (!g2_is_infinity(&sig_acc)) {
        fp_t gx, gy;
        memcpy(gx.d, FB_G1_X, sizeof gx.d);
        memcpy(gy.d, FB_G1_Y, sizeof gy.d);
        fp_neg(&gy, &gy);
        fp2_t sx, sy;
        g2_to_affine(&sx, &sy, &sig_acc);
        miller_loop_acc(&f, &gx, &gy, &sx, &sy);
    }
    fp12_t out;
    fp12_final_exp(&out, &f);
    return fp12_is_one(&out) ? FB_OK : FB_FAIL;
}

/* single full verify: e(pk, H(m)) == e(g1, sig) */
int fb_verify_one(const uint8_t *pk48, const uint8_t *msg32, const uint8_t *sig96) {
    uint32_t one = 1;
    uint64_t c = 1;
    return fb_batch_verify(1, pk48, &one, msg32, sig96, &c);
}

/* final exponentiation + is_one on a raw Fq12 given as 12 x 48-byte
 * big-endian fp values in tower order [A.c0.c0, A.c0.c1, A.c1.c0, A.c1.c1,
 * A.c2.c0, A.c2.c1, B.c0.c0, ...] (A + B w, each fq6 = c0 + c1 v + c2 v^2,
 * each fq2 = c0 + c1 u).  This is the host-side tail of the split TPU
 * dispatch: the device returns its batched Miller product, the host
 * finishes.  Returns 1/0, -1 on out-of-range bytes. */
int fb_final_exp_is_one(const uint8_t *f_bytes) {
    fp12_t f;
    fp_t *slots[12] = {
        &f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
        &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
        &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
    for (int i = 0; i < 12; i++)
        if (!fp_from_bytes(slots[i], f_bytes + 48 * i)) return FB_MALFORMED;
    fp12_t out;
    fp12_final_exp(&out, &f);
    return fp12_is_one(&out) ? FB_OK : FB_FAIL;
}

/* final exponentiation, bytes in/out (same layout) — differential tests */
int fb_final_exp(uint8_t *out_bytes, const uint8_t *f_bytes) {
    fp12_t f;
    fp_t *slots[12] = {
        &f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
        &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
        &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
    for (int i = 0; i < 12; i++)
        if (!fp_from_bytes(slots[i], f_bytes + 48 * i)) return FB_MALFORMED;
    fp12_t out;
    fp12_final_exp(&out, &f);
    const fp_t *oslots[12] = {
        &out.c0.c0.c0, &out.c0.c0.c1, &out.c0.c1.c0, &out.c0.c1.c1,
        &out.c0.c2.c0, &out.c0.c2.c1, &out.c1.c0.c0, &out.c1.c0.c1,
        &out.c1.c1.c0, &out.c1.c1.c1, &out.c1.c2.c0, &out.c1.c2.c1};
    for (int i = 0; i < 12; i++) fp_to_bytes(out_bytes + 48 * i, oslots[i]);
    return FB_OK;
}

/* pairing e(P, Q)^3 on compressed inputs, bytes out — differential tests */
int fb_pairing(uint8_t *out_bytes, const uint8_t *pk48, const uint8_t *sig96) {
    g1_t p;
    g2_t q;
    if (!g1_from_compressed(&p, pk48)) return FB_MALFORMED;
    if (!g2_from_compressed(&q, sig96)) return FB_MALFORMED;
    if (g1_is_infinity(&p) || g2_is_infinity(&q)) return FB_MALFORMED;
    fp_t ax, ay;
    g1_to_affine(&ax, &ay, &p);
    fp2_t qx, qy;
    g2_to_affine(&qx, &qy, &q);
    fp12_t f;
    fp12_one(&f);
    miller_loop_acc(&f, &ax, &ay, &qx, &qy);
    fp12_t out;
    fp12_final_exp(&out, &f);
    const fp_t *oslots[12] = {
        &out.c0.c0.c0, &out.c0.c0.c1, &out.c0.c1.c0, &out.c0.c1.c1,
        &out.c0.c2.c0, &out.c0.c2.c1, &out.c1.c0.c0, &out.c1.c0.c1,
        &out.c1.c1.c0, &out.c1.c1.c1, &out.c1.c2.c0, &out.c1.c2.c1};
    for (int i = 0; i < 12; i++) fp_to_bytes(out_bytes + 48 * i, oslots[i]);
    return FB_OK;
}

/* hash_to_g2 -> affine coords out as 4 x 48 bytes (x.c0, x.c1, y.c0, y.c1) */
int fb_hash_to_g2(uint8_t *out_192, const uint8_t *msg, size_t msg_len) {
    g2_t h;
    hash_to_g2(&h, msg, msg_len);
    fp2_t x, y;
    if (!g2_to_affine(&x, &y, &h)) return FB_MALFORMED;
    fp_to_bytes(out_192, &x.c0);
    fp_to_bytes(out_192 + 48, &x.c1);
    fp_to_bytes(out_192 + 96, &y.c0);
    fp_to_bytes(out_192 + 144, &y.c1);
    return FB_OK;
}

/* aggregate compressed pubkeys; writes affine x||y (96 bytes, non-mont BE).
 * Returns FB_FAIL for an infinity aggregate. */
int fb_aggregate_pubkeys(size_t n, const uint8_t *pks, uint8_t *out96) {
    g1_t acc;
    g1_infinity(&acc);
    for (size_t i = 0; i < n; i++) {
        g1_t p;
        if (!g1_from_compressed(&p, pks + 48 * i)) return FB_MALFORMED;
        g1_add(&acc, &acc, &p);
    }
    fp_t x, y;
    if (!g1_to_affine(&x, &y, &acc)) return FB_FAIL;
    fp_to_bytes(out96, &x);
    fp_to_bytes(out96 + 48, &y);
    return FB_OK;
}

/* ------------------------------------------------------------- signing -- */

/* ZCash compressed encodings (inverse of g1_from_compressed /
 * g2_from_compressed above): 0x80 = compressed, 0x20 = y lexicographically
 * greater, 0xC0 = infinity. */
static void g1_to_compressed(uint8_t *out48, const g1_t *p) {
    fp_t x, y;
    if (!g1_to_affine(&x, &y, p)) {
        memset(out48, 0, 48);
        out48[0] = 0xC0;
        return;
    }
    fp_to_bytes(out48, &x);
    out48[0] |= 0x80;
    if (fp_is_lex_greater(&y)) out48[0] |= 0x20;
}

static void g2_to_compressed(uint8_t *out96, const g2_t *p) {
    fp2_t x, y;
    if (!g2_to_affine(&x, &y, p)) {
        memset(out96, 0, 96);
        out96[0] = 0xC0;
        return;
    }
    fp_to_bytes(out96, &x.c1); /* c1 first on the wire */
    fp_to_bytes(out96 + 48, &x.c0);
    out96[0] |= 0x80;
    if (fp2_is_lex_greater(&y)) out96[0] |= 0x20;
}

/* big-endian 32-byte scalar -> little-endian u64 limbs; returns 0 when the
 * scalar is 0 or >= r (invalid secret key). */
static int scalar_from_be32(uint64_t e[4], const uint8_t *sk32) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | sk32[(3 - i) * 8 + j];
        e[i] = v;
    }
    if (!(e[0] | e[1] | e[2] | e[3])) return 0;
    for (int i = 3; i >= 0; i--) {
        if (e[i] < FB_ORDER[i]) return 1;
        if (e[i] > FB_ORDER[i]) return 0;
    }
    return 0; /* == r */
}

/* BLS sign, VARIABLE TIME: sig = sk * hash_to_g2(msg), compressed out.
 * The scalar mult is the sliding double-and-add g2_mul — its branch
 * pattern and iteration count encode the secret key, so this path is for
 * DEV/INTEROP USE ONLY (dev-chain fixtures, test suites, interop vectors
 * — where the keys are the published interop secrets and speed is what
 * matters; it skips the pure-Python G2 ladder, ~3 orders of magnitude
 * slower).  Production validator signing goes through fb_sign_ct below;
 * validator/store.py enforces the default. */
int fb_sign(uint8_t *out_sig96, const uint8_t *sk32, const uint8_t *msg,
            size_t msg_len) {
    uint64_t e[4];
    if (!scalar_from_be32(e, sk32)) return FB_MALFORMED;
    g2_t h, s;
    hash_to_g2(&h, msg, msg_len);
    g2_mul(&s, &h, e);
    g2_to_compressed(out_sig96, &s);
    return FB_OK;
}

/* BLS sign, constant-time-safe: identical bytes to fb_sign, but the
 * scalar mult is the fixed-length double-and-always-add ladder
 * (g2_mul_ct) — uniform operation sequence regardless of the key.  ~2x
 * the cost of fb_sign (every bit pays the add), still ~500x the Python
 * oracle.  The default signing path for ValidatorStore. */
int fb_sign_ct(uint8_t *out_sig96, const uint8_t *sk32, const uint8_t *msg,
               size_t msg_len) {
    uint64_t e[4];
    if (!scalar_from_be32(e, sk32)) return FB_MALFORMED;
    g2_t h, s;
    hash_to_g2(&h, msg, msg_len);
    g2_mul_ct(&s, &h, e);
    g2_to_compressed(out_sig96, &s);
    return FB_OK;
}

/* aggregate-sign: one signature by the SUM of n secret keys over one
 * message — equal to aggregating n individual signatures over that message
 * ((sum sk_i) * H(m) = sum sk_i * H(m)), but pays ONE hash_to_g2 and ONE
 * scalar mult instead of n of each.  The whole-committee signing shape of
 * dev chains / sim fixtures (sync aggregates, committee attestations). */
int fb_sign_aggregate(uint8_t *out_sig96, const uint8_t *sks, size_t n,
                      const uint8_t *msg, size_t msg_len) {
    if (n == 0) return FB_MALFORMED;
    uint64_t acc[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < n; i++) {
        uint64_t e[4];
        if (!scalar_from_be32(e, sks + 32 * i)) return FB_MALFORMED;
        /* acc = (acc + e) mod r: both < r so the sum < 2r; one conditional
         * subtract restores the range */
        unsigned __int128 carry = 0;
        for (int k = 0; k < 4; k++) {
            carry += (unsigned __int128)acc[k] + e[k];
            acc[k] = (uint64_t)carry;
            carry >>= 64;
        }
        int ge = (int)carry;
        if (!ge) {
            ge = 1;
            for (int k = 3; k >= 0; k--) {
                if (acc[k] < FB_ORDER[k]) { ge = 0; break; }
                if (acc[k] > FB_ORDER[k]) break;
            }
        }
        if (ge) {
            unsigned __int128 borrow = 0;
            for (int k = 0; k < 4; k++) {
                unsigned __int128 d =
                    (unsigned __int128)acc[k] - FB_ORDER[k] - (uint64_t)borrow;
                acc[k] = (uint64_t)d;
                borrow = (d >> 64) & 1;
            }
        }
    }
    if (!(acc[0] | acc[1] | acc[2] | acc[3])) return FB_FAIL; /* sum == 0 mod r */
    g2_t h, s;
    hash_to_g2(&h, msg, msg_len);
    g2_mul(&s, &h, acc);
    g2_to_compressed(out_sig96, &s);
    return FB_OK;
}

/* pk = sk * g1, compressed out. */
int fb_sk_to_pk(uint8_t *out_pk48, const uint8_t *sk32) {
    uint64_t e[4];
    if (!scalar_from_be32(e, sk32)) return FB_MALFORMED;
    g1_t g, p;
    memcpy(g.x.d, FB_G1_X, sizeof g.x.d);
    memcpy(g.y.d, FB_G1_Y, sizeof g.y.d);
    memcpy(g.z.d, FB_R1, sizeof g.z.d);
    g1_mul(&p, &g, e);
    g1_to_compressed(out_pk48, &p);
    return FB_OK;
}

/* aggregate compressed signatures -> compressed 96-byte aggregate. */
int fb_aggregate_sigs(size_t n, const uint8_t *sigs, uint8_t *out96) {
    g2_t acc;
    g2_infinity(&acc);
    for (size_t i = 0; i < n; i++) {
        g2_t p;
        if (!g2_from_compressed(&p, sigs + 96 * i)) return FB_MALFORMED;
        g2_add(&acc, &acc, &p);
    }
    g2_to_compressed(out96, &acc);
    return FB_OK;
}

/* aggregate compressed pubkeys -> compressed 48-byte aggregate. */
int fb_aggregate_pubkeys_c(size_t n, const uint8_t *pks, uint8_t *out48) {
    g1_t acc;
    g1_infinity(&acc);
    for (size_t i = 0; i < n; i++) {
        g1_t p;
        if (!g1_from_compressed(&p, pks + 48 * i)) return FB_MALFORMED;
        g1_add(&acc, &acc, &p);
    }
    g1_to_compressed(out48, &acc);
    return FB_OK;
}

/* self-test: e(g1, g2) is non-one, bilinearity e([2]g1, g2) == e(g1, [2]g2),
 * and sha256("") matches the known digest. */
int fb_selftest(void) {
    /* sha256 KAT */
    uint8_t d[32];
    sha256_ctx c;
    sha256_init(&c);
    sha256_final(&c, d);
    static const uint8_t empty[32] = {
        0xe3, 0xb0, 0xc4, 0x42, 0x98, 0xfc, 0x1c, 0x14, 0x9a, 0xfb, 0xf4,
        0xc8, 0x99, 0x6f, 0xb9, 0x24, 0x27, 0xae, 0x41, 0xe4, 0x64, 0x9b,
        0x93, 0x4c, 0xa4, 0x95, 0x99, 0x1b, 0x78, 0x52, 0xb8, 0x55};
    if (memcmp(d, empty, 32) != 0) return 0;
    /* pairing bilinearity */
    g1_t g1, g1_2;
    g2_t g2, g2_2;
    memcpy(g1.x.d, FB_G1_X, sizeof g1.x.d);
    memcpy(g1.y.d, FB_G1_Y, sizeof g1.y.d);
    memcpy(g1.z.d, FB_R1, sizeof g1.z.d);
    memcpy(g2.x.c0.d, FB_G2_X[0], 48);
    memcpy(g2.x.c1.d, FB_G2_X[1], 48);
    memcpy(g2.y.c0.d, FB_G2_Y[0], 48);
    memcpy(g2.y.c1.d, FB_G2_Y[1], 48);
    fp2_one(&g2.z);
    g1_double(&g1_2, &g1);
    g2_double(&g2_2, &g2);
    fp_t ax, ay, bx, by;
    fp2_t qx, qy, rx, ry;
    g1_to_affine(&ax, &ay, &g1);
    g1_to_affine(&bx, &by, &g1_2);
    g2_to_affine(&qx, &qy, &g2);
    g2_to_affine(&rx, &ry, &g2_2);
    fp12_t fa, fb, ea, eb;
    fp12_one(&fa);
    miller_loop_acc(&fa, &bx, &by, &qx, &qy); /* e([2]g1, g2) */
    fp12_final_exp(&ea, &fa);
    fp12_one(&fb);
    miller_loop_acc(&fb, &ax, &ay, &rx, &ry); /* e(g1, [2]g2) */
    fp12_final_exp(&eb, &fb);
    if (fp12_is_one(&ea)) return 0;
    /* compare */
    if (memcmp(&ea, &eb, sizeof ea) != 0) {
        /* allow representation differences: compare via subtraction */
        fp12_t inv, quot;
        fp12_inv(&inv, &eb);
        fp12_mul(&quot, &ea, &inv);
        if (!fp12_is_one(&quot)) return 0;
    }
    /* subgroup checks accept the generators */
    if (!g1_subgroup_check(&g1)) return 0;
    if (!g2_subgroup_check(&g2)) return 0;
    /* constant-time ladder == variable-time ladder (same compressed
     * bytes for the same scalar), including a low-Hamming-weight scalar
     * whose fixed-length handling is the part g2_mul skips */
    {
        uint8_t sk[32] = {0}, a[96], b[96];
        sk[31] = 5;
        if (fb_sign(a, sk, (const uint8_t *)"ct", 2) != FB_OK) return 0;
        if (fb_sign_ct(b, sk, (const uint8_t *)"ct", 2) != FB_OK) return 0;
        if (memcmp(a, b, 96) != 0) return 0;
        sk[0] = 0x42;
        if (fb_sign(a, sk, (const uint8_t *)"ct2", 3) != FB_OK) return 0;
        if (fb_sign_ct(b, sk, (const uint8_t *)"ct2", 3) != FB_OK) return 0;
        if (memcmp(a, b, 96) != 0) return 0;
    }
    return 1;
}
