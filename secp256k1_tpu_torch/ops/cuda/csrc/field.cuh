// Field core of the verify-path kernels: arithmetic mod p and mod n on
// 8 x 32-bit little-endian words held in registers.
//
// Replaces the in-kernel field arithmetic of the Pallas kernels
// (secp256k1_tpu/ops/pallas/kernels.py: _mul_rows :76, _sqr_rows :102,
// _reduce_wide :265, _add_rows/_sub_rows :357-377), which works on 16-bit
// limbs in u32 because the TPU has no add-with-carry and no 64-bit integers.
// Hopper has both, so a product here is an 8 x 8 schoolbook of 32 x 32 -> 64
// bit multiply-adds (64 of them) instead of 256 16 x 16 products.
//
// Both moduli are m = 2^256 - c.  A 512-bit product folds with
// 2^256 = c (mod m): for p, c = 2^32 + 977 (two words, one of them 1); for
// n, c is 129 bits (five words, the top one 1), so the fold takes more
// rounds, as _reduce_wide does with a multi-limb c.  Every function returns a
// canonical value (< m) from canonical inputs; fe_mul and fe_sqr accept any
// inputs < 2^256.
//
// Memory layout at the kernel boundary: int32 planes [16, B] of 16-bit limbs,
// limb-major, so a warp's 32 threads (32 lanes) read 128 contiguous bytes per
// limb.  load_fe / store_fe pack two limbs into one word.
//
// Bound: 32-bit integer multiply-adds.  A field multiply is 64 wide products
// plus ~10 for the p fold (~60 for n); nothing here touches memory between
// the load and the store.
#pragma once

#include <cstdint>

typedef uint32_t u32;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Moduli.  c(j): the words of c = 2^256 - m; m(j): the words of m.
// ---------------------------------------------------------------------------

struct ModP {
  static constexpr int NC = 2;
  __device__ static __forceinline__ u32 c(int j) { return j == 0 ? 977u : 1u; }
  __device__ static __forceinline__ u32 m(int j) {
    return j == 0 ? 0xFFFFFC2Fu : (j == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
  }
};

struct ModN {
  static constexpr int NC = 5;
  __device__ static __forceinline__ u32 c(int j) {
    return j == 0 ? 0x2FC9BEBFu
         : j == 1 ? 0x402DA173u
         : j == 2 ? 0x50B75FC4u
         : j == 3 ? 0x45512319u
                  : 1u;
  }
  __device__ static __forceinline__ u32 m(int j) {
    return j == 0 ? 0xD0364141u
         : j == 1 ? 0xBFD25E8Cu
         : j == 2 ? 0xAF48A03Bu
         : j == 3 ? 0xBAAEDCE6u
         : j == 4 ? 0xFFFFFFFEu
                  : 0xFFFFFFFFu;
  }
};

// ---------------------------------------------------------------------------
// Plane <-> register words.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_fe(const int* plane, int lanes, int lane,
                                        u32 out[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u32 lo = (u32)plane[(size_t)(2 * k) * lanes + lane];
    u32 hi = (u32)plane[(size_t)(2 * k + 1) * lanes + lane];
    out[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store_fe(int* plane, int lanes, int lane,
                                         const u32 v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    plane[(size_t)(2 * k) * lanes + lane] = (int)(v[k] & 0xFFFFu);
    plane[(size_t)(2 * k + 1) * lanes + lane] = (int)(v[k] >> 16);
  }
}

__device__ __forceinline__ void fe_copy(u32 d[8], const u32 s[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = s[k];
}

__device__ __forceinline__ void fe_set_small(u32 d[8], u32 v) {
  d[0] = v;
#pragma unroll
  for (int k = 1; k < 8; ++k) d[k] = 0;
}

// d = mask ? a : d, branch-free (mask is all ones or zero).
__device__ __forceinline__ void fe_cmov(u32 d[8], const u32 a[8], u32 mask) {
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = (a[k] & mask) | (d[k] & ~mask);
}

// ---------------------------------------------------------------------------
// Wide products.
// ---------------------------------------------------------------------------

// r = a * b (512 bits).  Row i adds a[i] * b into r[i..i+8]; each step is
// (2^32-1)^2 + 2 (2^32-1) < 2^64, so a u64 holds product, word and carry.
__device__ __forceinline__ void mul_wide(const u32 a[8], const u32 b[8],
                                         u32 r[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (u64)a[i] * b[j] + r[i + j];
      r[i + j] = (u32)c;
      c >>= 32;
    }
    r[i + 8] = (u32)c;
  }
}

// r = a^2: the 28 off-diagonal products once, doubled by a one-bit shift,
// plus the 8 squares.
__device__ __forceinline__ void sqr_wide(const u32 a[8], u32 r[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      c += (u64)a[i] * a[j] + r[i + j];
      r[i + j] = (u32)c;
      c >>= 32;
    }
    r[i + 8] = (u32)c;
  }
  u32 top = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    u32 nt = r[k] >> 31;
    r[k] = (r[k] << 1) | top;
    top = nt;
  }
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 d = (u64)a[i] * a[i];
    c += (u64)r[2 * i] + (u32)d;
    r[2 * i] = (u32)c;
    c >>= 32;
    c += (u64)r[2 * i + 1] + (d >> 32);
    r[2 * i + 1] = (u32)c;
    c >>= 32;
  }
}

// ---------------------------------------------------------------------------
// Reduction mod m = 2^256 - c.
// ---------------------------------------------------------------------------

// out[0 .. OUTN) = lo[0..8) + h[0..NH) * c.  OUTN must hold the result.
template <class M, int NH, int OUTN>
__device__ __forceinline__ void fold_add(const u32 lo[8], const u32 h[NH],
                                         u32 out[OUTN]) {
#pragma unroll
  for (int k = 0; k < OUTN; ++k) out[k] = 0;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < M::NC; ++j) {
      c += (u64)h[i] * M::c(j) + out[i + j];
      out[i + j] = (u32)c;
      c >>= 32;
    }
    out[i + M::NC] = (u32)c;
  }
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < OUTN; ++k) {
    c += (u64)out[k] + (k < 8 ? lo[k] : 0u);
    out[k] = (u32)c;
    c >>= 32;
  }
}

// out = lo + h * c for one word h; returns the carry out of 2^256.
template <class M>
__device__ __forceinline__ u32 fold_word(const u32 lo[8], u32 h, u32 out[8]) {
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (u64)lo[j] + (j < M::NC ? (u64)h * M::c(j) : 0ull);
    out[j] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

// out = x - m if x >= m else x  (x < 2^256).
template <class M>
__device__ __forceinline__ void cond_sub(const u32 x[8], u32 out[8]) {
  u32 d[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u64 t = (u64)x[j] - M::m(j) - borrow;
    d[j] = (u32)t;
    borrow = t >> 63;
  }
  u32 keep = 0u - (u32)borrow;  // all ones where x < m
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = (x[j] & keep) | (d[j] & ~keep);
}

// Canonical r mod m of a 512-bit r.
//   round 1: t = lo + hi * c           (< 2^256 (1 + c): 8 + NC words)
//   round 2: s = t_lo + t_hi * c       (p: < 2^256 + 2^67; n: < 2^260)
//   round 3: u = s_lo + s[8] * c       (carry out 0 or 1)
//   round 4: u += carry * c            (no carry: u_lo is small then)
//   then one conditional subtract, since u < 2^256 < 2m.
template <class M>
__device__ __forceinline__ void reduce_wide(const u32 r[16], u32 out[8]) {
  constexpr int T = 8 + M::NC + 1;
  u32 t[T];
  fold_add<M, 8, T>(r, r + 8, t);
  constexpr int S = (2 * M::NC > 8 ? 2 * M::NC : 8) + 1;
  u32 s[S];
  fold_add<M, M::NC, S>(t, t + 8, s);
  u32 u[8];
  u32 carry = fold_word<M>(s, s[8], u);
  fold_word<M>(u, carry, u);
  cond_sub<M>(u, out);
}

template <class M>
__device__ __forceinline__ void fe_mul(const u32 a[8], const u32 b[8],
                                       u32 out[8]) {
  u32 r[16];
  mul_wide(a, b, r);
  reduce_wide<M>(r, out);
}

template <class M>
__device__ __forceinline__ void fe_sqr(const u32 a[8], u32 out[8]) {
  u32 r[16];
  sqr_wide(a, r);
  reduce_wide<M>(r, out);
}

// (a + b) mod m: a 257-bit sum, then subtract m where it is >= m.
template <class M>
__device__ __forceinline__ void fe_add(const u32 a[8], const u32 b[8],
                                       u32 out[8]) {
  u32 s[8];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (u64)a[j] + b[j];
    s[j] = (u32)c;
    c >>= 32;
  }
  u32 d[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u64 t = (u64)s[j] - M::m(j) - borrow;
    d[j] = (u32)t;
    borrow = t >> 63;
  }
  // keep the sum where the 257-bit value s + 2^256 c8 is < m.
  u32 keep = 0u - (u32)(borrow & (c ^ 1ull));
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = (s[j] & keep) | (d[j] & ~keep);
}

// (a - b) mod m: subtract, add m back where it borrowed.
template <class M>
__device__ __forceinline__ void fe_sub(const u32 a[8], const u32 b[8],
                                       u32 out[8]) {
  u32 d[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u64 t = (u64)a[j] - b[j] - borrow;
    d[j] = (u32)t;
    borrow = t >> 63;
  }
  u32 mask = 0u - (u32)borrow;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (u64)d[j] + (M::m(j) & mask);
    out[j] = (u32)c;
    c >>= 32;
  }
}

template <class M>
__device__ __forceinline__ void fe_neg(const u32 b[8], u32 out[8]) {
  u32 zero[8];
  fe_set_small(zero, 0);
  fe_sub<M>(zero, b, out);
}

// a * w mod m for a small word w (b3 = 21): 9 words, two word folds.
template <class M>
__device__ __forceinline__ void fe_mulw(const u32 a[8], u32 w, u32 out[8]) {
  u32 t[8];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (u64)a[j] * w;
    t[j] = (u32)c;
    c >>= 32;
  }
  u32 u[8];
  u32 carry = fold_word<M>(t, (u32)c, u);
  fold_word<M>(u, carry, u);
  cond_sub<M>(u, out);
}
