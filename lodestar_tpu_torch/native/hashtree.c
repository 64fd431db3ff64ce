/* hashtree.c — batched SHA-256 merkle-layer hashing for the SSZ host path.
 *
 * The runtime-native analog of the reference's as-sha256/hashtree deps
 * (SURVEY.md §2.9: ssz merkleization is a native concern there too): one
 * C call hashes a whole tree layer (consecutive 64-byte blocks -> 32-byte
 * digests), removing the per-pair Python/hashlib round trips that
 * dominate hash_tree_root on beacon states.
 *
 * SHA-256 per FIPS 180-4.  Each 64-byte input block is one single-block
 * message (length 512 bits), so the padding block is constant and the
 * schedule for it is precomputable — we fold it in directly.
 *
 * Build: cc -O3 -shared -fPIC -o libhashtree.so hashtree.c
 * Binding: lodestar_tpu/native/hashtree.py (ctypes).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static const uint32_t K[64] = {
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

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))
#define CH(x, y, z) (((x) & (y)) ^ (~(x) & (z)))
#define MAJ(x, y, z) (((x) & (y)) ^ ((x) & (z)) ^ ((y) & (z)))
#define EP0(x) (ROTR(x, 2) ^ ROTR(x, 13) ^ ROTR(x, 22))
#define EP1(x) (ROTR(x, 6) ^ ROTR(x, 11) ^ ROTR(x, 25))
#define SIG0(x) (ROTR(x, 7) ^ ROTR(x, 18) ^ ((x) >> 3))
#define SIG1(x) (ROTR(x, 17) ^ ROTR(x, 19) ^ ((x) >> 10))

static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                               0xa54ff53a, 0x510e527f, 0x9b05688c,
                               0x1f83d9ab, 0x5be0cd19};

static void compress(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  uint32_t a, b, c, d, e, f, g, h, t1, t2;
  int i;
  for (i = 0; i < 16; i++)
    w[i] = ((uint32_t)block[i * 4] << 24) | ((uint32_t)block[i * 4 + 1] << 16) |
           ((uint32_t)block[i * 4 + 2] << 8) | (uint32_t)block[i * 4 + 3];
  for (i = 16; i < 64; i++)
    w[i] = SIG1(w[i - 2]) + w[i - 7] + SIG0(w[i - 15]) + w[i - 16];
  a = state[0]; b = state[1]; c = state[2]; d = state[3];
  e = state[4]; f = state[5]; g = state[6]; h = state[7];
  for (i = 0; i < 64; i++) {
    t1 = h + EP1(e) + CH(e, f, g) + K[i] + w[i];
    t2 = EP0(a) + MAJ(a, b, c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

/* The constant second block of every 64-byte message: 0x80 pad + length
 * 512 bits.  Precompute its expanded schedule contribution by just
 * compressing it normally (cheap enough; the win is batching). */
static const uint8_t PADBLOCK[64] = {[0] = 0x80, [62] = 0x02, [63] = 0x00};

#if defined(__x86_64__)
#include <immintrin.h>

/* SHA-NI single-block compress (Intel SHA extensions round pattern). */
__attribute__((target("sha,sse4.1")))
static void compress_ni(uint32_t state[8], const uint8_t block[64]) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;
  __m128i ABEF_SAVE, CDGH_SAVE;

  TMP = _mm_loadu_si128((const __m128i *)&state[0]);    /* DCBA */
  STATE1 = _mm_loadu_si128((const __m128i *)&state[4]); /* HGFE */
  TMP = _mm_shuffle_epi32(TMP, 0xB1);       /* CDAB */
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B); /* EFGH */
  STATE0 = _mm_alignr_epi8(TMP, STATE1, 8); /* ABEF */
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0); /* CDGH */

  ABEF_SAVE = STATE0;
  CDGH_SAVE = STATE1;

#define QROUND(Ki, M)                                                       \
  do {                                                                      \
    MSG = _mm_add_epi32(M, _mm_loadu_si128((const __m128i *)&K[Ki]));       \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);                    \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                                     \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);                    \
  } while (0)

  MSG0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(block + 0)), MASK);
  MSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(block + 16)), MASK);
  MSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(block + 32)), MASK);
  MSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(block + 48)), MASK);

  QROUND(0, MSG0);
  QROUND(4, MSG1);
  QROUND(8, MSG2);
  QROUND(12, MSG3);

#define EXPAND(Ma, Mb, Mc, Md)                                              \
  do {                                                                      \
    Ma = _mm_sha256msg2_epu32(                                              \
        _mm_add_epi32(_mm_sha256msg1_epu32(Ma, Mb),                         \
                      _mm_alignr_epi8(Md, Mc, 4)),                          \
        Md);                                                                \
  } while (0)

  { int r;
    for (r = 16; r < 64; r += 16) {
      EXPAND(MSG0, MSG1, MSG2, MSG3);
      QROUND(r + 0, MSG0);
      EXPAND(MSG1, MSG2, MSG3, MSG0);
      QROUND(r + 4, MSG1);
      EXPAND(MSG2, MSG3, MSG0, MSG1);
      QROUND(r + 8, MSG2);
      EXPAND(MSG3, MSG0, MSG1, MSG2);
      QROUND(r + 12, MSG3);
    }
  }
#undef QROUND
#undef EXPAND

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);       /* FEBA */
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    /* DCHG */
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); /* DCBA */
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    /* HGFE */

  _mm_storeu_si128((__m128i *)&state[0], STATE0);
  _mm_storeu_si128((__m128i *)&state[4], STATE1);
}

static int have_shani(void) {
  return __builtin_cpu_supports("sha") && __builtin_cpu_supports("sse4.1");
}
#else
static void compress_ni(uint32_t state[8], const uint8_t block[64]) {
  compress(state, block);
}
static int have_shani(void) { return 0; }
#endif

/* hash `n` consecutive 64-byte blocks from `in` into `n` 32-byte digests */
void hashtree_hash_layer(const uint8_t *in, size_t n, uint8_t *out) {
  size_t i;
  int j;
  int ni = have_shani();
  for (i = 0; i < n; i++) {
    uint32_t s[8];
    memcpy(s, H0, sizeof(s));
    if (ni) {
      compress_ni(s, in + i * 64);
      compress_ni(s, PADBLOCK);
    } else {
      compress(s, in + i * 64);
      compress(s, PADBLOCK);
    }
    for (j = 0; j < 8; j++) {
      out[i * 32 + j * 4] = (uint8_t)(s[j] >> 24);
      out[i * 32 + j * 4 + 1] = (uint8_t)(s[j] >> 16);
      out[i * 32 + j * 4 + 2] = (uint8_t)(s[j] >> 8);
      out[i * 32 + j * 4 + 3] = (uint8_t)(s[j]);
    }
  }
}

/* full sha256 for arbitrary input (digest of `len` bytes) — used by the
 * snappy codec and signing-root helpers when the lib is loaded anyway */
void hashtree_sha256(const uint8_t *in, size_t len, uint8_t *out32) {
  uint32_t s[8];
  uint8_t block[64];
  size_t full = len / 64, i;
  uint64_t bits = (uint64_t)len * 8;
  memcpy(s, H0, sizeof(s));
  for (i = 0; i < full; i++) compress(s, in + i * 64);
  {
    size_t rem = len - full * 64;
    memset(block, 0, 64);
    memcpy(block, in + full * 64, rem);
    block[rem] = 0x80;
    if (rem >= 56) {
      compress(s, block);
      memset(block, 0, 64);
    }
    for (i = 0; i < 8; i++) block[56 + i] = (uint8_t)(bits >> (56 - 8 * i));
    compress(s, block);
  }
  for (i = 0; i < 8; i++) {
    out32[i * 4] = (uint8_t)(s[i] >> 24);
    out32[i * 4 + 1] = (uint8_t)(s[i] >> 16);
    out32[i * 4 + 2] = (uint8_t)(s[i] >> 8);
    out32[i * 4 + 3] = (uint8_t)(s[i]);
  }
}
