// Field core of the kernels: arithmetic mod p and mod n on 8 x 32-bit
// little-endian words held in registers.
//
// Replaces the in-kernel field arithmetic of the Pallas kernels
// (secp256k1_tpu/ops/pallas/kernels.py: _mul_rows :76, _sqr_rows :102,
// _reduce_wide :265, _add_rows/_sub_rows :357-377), which works on 16-bit
// limbs in u32 because the TPU has no add-with-carry and no 64-bit integers.
// Hopper has both, so a product here is an 8 x 8 schoolbook of 32 x 32-bit
// multiply-adds (64 of them) instead of 256 16 x 16 products.
//
// Carry chains: every multi-word sum, difference and product row is one
// chain of PTX add/sub/mad instructions with carry in and out (add.cc,
// addc.cc, mad.lo.cc, madc.hi.cc, ...), with no separate carry arithmetic;
// ptxas turns each (mad.lo, madc.hi) pair into one wide multiply-add with
// the carry in a predicate, and overlaps independent chains.  A row of the
// schoolbook is split by the parity of the word a product's (lo, hi) pair
// lands on into two chains whose pairs tile their words without overlap
// (even and odd accumulators, added once at the end), so no chain adds two
// values into one word and no register pair shifts between rows.
// Without nvcc (a plain C++ compiler) the same primitives are emulated with
// a carry variable, so the arithmetic can be checked on the host against
// python ints.
//
// Both moduli are m = 2^256 - c.  A 512-bit product folds with
// 2^256 = c (mod m): for p, c = 2^32 + 977, folded by a specialized
// carry-chain reduction; for n, c is 129 bits (five words, the top one 1),
// so the fold takes more rounds, as _reduce_wide does with a multi-limb c.
// Every function returns a canonical value (< m) from canonical inputs;
// fe_mul and fe_sqr accept any inputs < 2^256.  The mod-p functions with
// the reduction deferred (at the end) take and give any values < 2^256.
//
// Memory layout at the kernel boundary: int32 planes [16, B] of 16-bit limbs,
// limb-major, so a warp's 32 threads (32 lanes) read 128 contiguous bytes per
// limb.  load_fe / store_fe pack two limbs into one word.
//
// Bound: 32-bit integer multiply-adds.  A field multiply is 64 wide products
// plus ~12 for the p fold (~60 for n); nothing here touches memory between
// the load and the store.
#pragma once

#include <cstddef>
#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

typedef uint32_t u32;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Carry-chain primitives.  The carry flag links consecutive calls: a chain
// starts with a *_cc form without carry in and ends with a form without
// carry out (or is read by addc(0, 0) / subc(0, 0)).
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

#define FIELD_ASM2(name, op)                                               \
  __device__ __forceinline__ u32 name(u32 a, u32 b) {                      \
    u32 r;                                                                 \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                              \
  }
#define FIELD_ASM3(name, op)                                               \
  __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {               \
    u32 r;                                                                 \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
FIELD_ASM2(add_cc, "add.cc.u32")
FIELD_ASM2(addc_cc, "addc.cc.u32")
FIELD_ASM2(addc, "addc.u32")
FIELD_ASM2(sub_cc, "sub.cc.u32")
FIELD_ASM2(subc_cc, "subc.cc.u32")
FIELD_ASM2(subc, "subc.u32")
FIELD_ASM3(madlo_cc, "mad.lo.cc.u32")
FIELD_ASM3(madloc_cc, "madc.lo.cc.u32")
FIELD_ASM3(madhic_cc, "madc.hi.cc.u32")
#undef FIELD_ASM2
#undef FIELD_ASM3

__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }

#else  // host emulation: cc_flag stands for the carry flag (borrow in subs)

static thread_local u32 cc_flag;

inline u32 cc_out(u64 s) {
  cc_flag = (u32)(s >> 32) & 1u;
  return (u32)s;
}
inline u32 add_cc(u32 a, u32 b) { return cc_out((u64)a + b); }
inline u32 addc_cc(u32 a, u32 b) { return cc_out((u64)a + b + cc_flag); }
inline u32 addc(u32 a, u32 b) { return a + b + cc_flag; }
inline u32 sub_cc(u32 a, u32 b) { return cc_out((u64)a - b); }
inline u32 subc_cc(u32 a, u32 b) { return cc_out((u64)a - b - cc_flag); }
inline u32 subc(u32 a, u32 b) { return a - b - cc_flag; }
inline u32 madlo_cc(u32 a, u32 b, u32 c) { return cc_out((u64)(a * b) + c); }
inline u32 madloc_cc(u32 a, u32 b, u32 c) {
  return cc_out((u64)(a * b) + c + cc_flag);
}
inline u32 mulhi(u32 a, u32 b) { return (u32)(((u64)a * b) >> 32); }
inline u32 madhic_cc(u32 a, u32 b, u32 c) {
  return cc_out((u64)mulhi(a, b) + c + cc_flag);
}

#endif

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

// acc += (lo, hi) of a[J0] * b, a[J0 + 2] * b, ... up to a[7] (pairs that
// tile consecutive words from acc[0]), the carry out added into the word
// after the last pair (which holds at most one earlier carry).
template <int J0>
__device__ __forceinline__ void mad_pairs(const u32 a[8], u32 b, u32* acc) {
  acc[0] = madlo_cc(a[J0], b, acc[0]);
  acc[1] = madhic_cc(a[J0], b, acc[1]);
#pragma unroll
  for (int j = J0 + 2; j < 8; j += 2) {
    acc[j - J0] = madloc_cc(a[j], b, acc[j - J0]);
    acc[j - J0 + 1] = madhic_cc(a[j], b, acc[j - J0 + 1]);
  }
  constexpr int END = 2 * ((8 - J0 + 1) / 2);
  acc[END] = addc(acc[END], 0u);
}

// r = a * b (512 bits).  Row i adds the pair (lo, hi) of a[j] * b[i] at
// word i + j: the pairs with i + j even into ev (ev[k] is word k), the
// others into od (od[k] is word k + 1), each as one carry chain.  So every
// pair lands on the same even-aligned word pair of its accumulator in
// every row, as the register pairs of a wide multiply-add want (no moves
// between rows).
__device__ __forceinline__ void mul_wide(const u32 a[8], const u32 b[8],
                                         u32 r[16]) {
  u32 ev[17], od[16];
#pragma unroll
  for (int k = 0; k < 17; ++k) ev[k] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) od[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mad_pairs<0>(a, b[i], ev + i);          // j even: words i, i+2, ..
    mad_pairs<1>(a, b[i], od + i);          // j odd: words i+1, i+3, ..
    mad_pairs<1>(a, b[i + 1], ev + i + 2);  // j odd: words i+2, i+4, ..
    mad_pairs<0>(a, b[i + 1], od + i);      // j even: words i+1, i+3, ..
  }
  // r = ev + od * 2^32; word 16 (ev[16], od[15]) is 0 since a * b < 2^512.
  r[0] = ev[0];
  r[1] = add_cc(ev[1], od[0]);
#pragma unroll
  for (int k = 2; k < 15; ++k) r[k] = addc_cc(ev[k], od[k - 1]);
  r[15] = addc(ev[15], od[14]);
}

// r = a^2: the 28 products a[i] * a[j], i < j, once (row i over j > i,
// split by parity as in mul_wide), doubled by adding the sum to itself,
// then the 8 squares a[i]^2 at words 2i, 2i + 1 in one chain: 36 wide
// products instead of 64.
template <int I>
__device__ __forceinline__ void sqr_row(const u32 a[8], u32* ev, u32* od) {
  if (I + 2 < 8) mad_pairs<(I + 2 < 8 ? I + 2 : 7)>(a, a[I], ev + 2 * I + 2);
  mad_pairs<I + 1>(a, a[I], od + 2 * I);
}

__device__ __forceinline__ void sqr_wide(const u32 a[8], u32 r[16]) {
  u32 ev[17], od[16];
#pragma unroll
  for (int k = 0; k < 17; ++k) ev[k] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) od[k] = 0;
  sqr_row<0>(a, ev, od);
  sqr_row<1>(a, ev, od);
  sqr_row<2>(a, ev, od);
  sqr_row<3>(a, ev, od);
  sqr_row<4>(a, ev, od);
  sqr_row<5>(a, ev, od);
  sqr_row<6>(a, ev, od);
  // x = ev + od * 2^32 (words 1..14), then r = 2x + the squares.
  u32 x[16];
  x[0] = 0;
  x[1] = od[0];
  x[2] = add_cc(ev[2], od[1]);
#pragma unroll
  for (int k = 3; k < 15; ++k) x[k] = addc_cc(ev[k], od[k - 1]);
  x[15] = addc(ev[15], od[14]);
  x[1] = add_cc(x[1], x[1]);
#pragma unroll
  for (int k = 2; k < 16; ++k) x[k] = addc_cc(x[k], x[k]);
  r[0] = madlo_cc(a[0], a[0], 0u);
  r[1] = madhic_cc(a[0], a[0], x[1]);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    r[2 * i] = madloc_cc(a[i], a[i], x[2 * i]);
    r[2 * i + 1] = madhic_cc(a[i], a[i], x[2 * i + 1]);
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

// Mod p: h * c = h * 977 + h * 2^32 is three words (w0, w1, w2), added to
// lo by one chain.
template <>
__device__ __forceinline__ u32 fold_word<ModP>(const u32 lo[8], u32 h,
                                               u32 out[8]) {
  const u32 w0 = h * 977u;
  const u32 w1 = add_cc(mulhi(h, 977u), h);
  const u32 w2 = addc(0u, 0u);
  out[0] = add_cc(lo[0], w0);
  out[1] = addc_cc(lo[1], w1);
  out[2] = addc_cc(lo[2], w2);
#pragma unroll
  for (int j = 3; j < 8; ++j) out[j] = addc_cc(lo[j], 0u);
  return addc(0u, 0u);
}

// out = x - m if x >= m else x  (x < 2^256).
template <class M>
__device__ __forceinline__ void cond_sub(const u32 x[8], u32 out[8]) {
  u32 d[8];
  d[0] = sub_cc(x[0], M::m(0));
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(x[j], M::m(j));
  const u32 keep = subc(0u, 0u);  // all ones where x < m
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

// Mod p, the same four rounds as carry chains, without the conditional
// subtract: out < 2^256, congruent to r (mod p).  Round 1 splits h * 977 by
// the parity of h's word: ev = lo + (lo, hi) of h[0, 2, 4, 6] * 977 at
// words 0..8, od = h (shifted one word) + (lo, hi) of h[1, 3, 5, 7] * 977
// at words 1..9; t = ev + od < 2^289 (t[9] is 0 or 1).  Round 2 folds
// H = t[8] + 2^32 t[9] as the three words of H * c.
__device__ __forceinline__ void reduce_wide_lazy_p(const u32 r[16],
                                                   u32 out[8]) {
  const u32* h = r + 8;
  u32 ev[9], od[9];  // od[k] is word k + 1
  ev[0] = madlo_cc(h[0], 977u, r[0]);
  ev[1] = madhic_cc(h[0], 977u, r[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    ev[j] = madloc_cc(h[j], 977u, r[j]);
    ev[j + 1] = madhic_cc(h[j], 977u, r[j + 1]);
  }
  ev[8] = addc(0u, 0u);
  od[0] = madlo_cc(h[1], 977u, h[0]);
  od[1] = madhic_cc(h[1], 977u, h[1]);
#pragma unroll
  for (int j = 3; j < 8; j += 2) {
    od[j - 1] = madloc_cc(h[j], 977u, h[j - 1]);
    od[j] = madhic_cc(h[j], 977u, h[j]);
  }
  od[8] = addc(0u, 0u);
  u32 t[10];
  t[0] = ev[0];
  t[1] = add_cc(ev[1], od[0]);
#pragma unroll
  for (int k = 2; k < 9; ++k) t[k] = addc_cc(ev[k], od[k - 1]);
  t[9] = addc(0u, od[8]);
  // Round 2: H * c = t8 * 977 + 2^32 (t9 * 977 + t8) + 2^64 t9.
  const u32 w0 = t[8] * 977u;
  const u32 w1 = add_cc(mulhi(t[8], 977u) + t[9] * 977u, t[8]);
  const u32 w2 = addc(t[9], 0u);
  u32 s[8];
  s[0] = add_cc(t[0], w0);
  s[1] = addc_cc(t[1], w1);
  s[2] = addc_cc(t[2], w2);
#pragma unroll
  for (int j = 3; j < 8; ++j) s[j] = addc_cc(t[j], 0u);
  const u32 s8 = addc(0u, 0u);
  const u32 carry = fold_word<ModP>(s, s8, out);
  fold_word<ModP>(out, carry, out);
}

template <>
__device__ __forceinline__ void reduce_wide<ModP>(const u32 r[16],
                                                  u32 out[8]) {
  u32 u[8];
  reduce_wide_lazy_p(r, u);
  cond_sub<ModP>(u, out);
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
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) s[j] = addc_cc(a[j], b[j]);
  const u32 c8 = addc(0u, 0u);
  u32 d[8];
  d[0] = sub_cc(s[0], M::m(0));
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(s[j], M::m(j));
  // c8 - borrow is all ones exactly where the 257-bit sum is < m: keep it.
  const u32 keep = subc(c8, 0u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = (s[j] & keep) | (d[j] & ~keep);
}

// (a - b) mod m: subtract, add m back where it borrowed.
template <class M>
__device__ __forceinline__ void fe_sub(const u32 a[8], const u32 b[8],
                                       u32 out[8]) {
  u32 d[8];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], b[j]);
  const u32 mask = subc(0u, 0u);  // all ones where a < b
  out[0] = add_cc(d[0], M::m(0) & mask);
#pragma unroll
  for (int j = 1; j < 7; ++j) out[j] = addc_cc(d[j], M::m(j) & mask);
  out[7] = addc(d[7], M::m(7) & mask);
}

template <class M>
__device__ __forceinline__ void fe_neg(const u32 b[8], u32 out[8]) {
  u32 zero[8];
  fe_set_small(zero, 0);
  fe_sub<M>(zero, b, out);
}

// a * w for a small word w (b3 = 21), below 2^256 and congruent mod m:
// 9 words, two word folds.
template <class M>
__device__ __forceinline__ void mulw_folded(const u32 a[8], u32 w,
                                            u32 out[8]) {
  u32 t[8];
  t[0] = a[0] * w;
  t[1] = add_cc(mulhi(a[0], w), a[1] * w);
#pragma unroll
  for (int j = 2; j < 8; ++j) t[j] = addc_cc(mulhi(a[j - 1], w), a[j] * w);
  const u32 t8 = addc(mulhi(a[7], w), 0u);
  u32 carry = fold_word<M>(t, t8, out);
  fold_word<M>(out, carry, out);
}

// a * w mod m for a small word w, canonical.
template <class M>
__device__ __forceinline__ void fe_mulw(const u32 a[8], u32 w, u32 out[8]) {
  u32 u[8];
  mulw_folded<M>(a, w, u);
  cond_sub<M>(u, out);
}

// ---------------------------------------------------------------------------
// Mod p with the reduction deferred: every result is below 2^256 and
// congruent to the canonical one, but may lie in [p, 2^256); cond_sub<ModP>
// makes a value canonical.  Inputs are any values below 2^256.  A product
// skips reduce_wide's conditional subtract (a product by a word is
// mulw_folded<ModP>); a sum folds a carry out of 2^256 as c = 2^32 + 977
// in place of comparing with p, and a difference takes c off on a borrow.
// Either may need that fold twice (a sum of two values in [p, 2^256), a
// difference a - b below -p), and then the value is within c of 0 or of
// 2^256, so the second fold touches words 0 and 1 only.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fe_mul_lazy(const u32 a[8], const u32 b[8],
                                            u32 out[8]) {
  u32 r[16];
  mul_wide(a, b, r);
  reduce_wide_lazy_p(r, out);
}

__device__ __forceinline__ void fe_sqr_lazy(const u32 a[8], u32 out[8]) {
  u32 r[16];
  sqr_wide(a, r);
  reduce_wide_lazy_p(r, out);
}

// a + b: a carry out of 2^256 adds c; if that carries too, the value is
// below c and takes c once more.
__device__ __forceinline__ void fe_add_lazy(const u32 a[8], const u32 b[8],
                                            u32 out[8]) {
  u32 s[8];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) s[j] = addc_cc(a[j], b[j]);
  u32 carry = addc(0u, 0u);
  out[0] = add_cc(s[0], carry * 977u);
  out[1] = addc_cc(s[1], carry);
#pragma unroll
  for (int j = 2; j < 8; ++j) out[j] = addc_cc(s[j], 0u);
  carry = addc(0u, 0u);
  out[0] = add_cc(out[0], carry * 977u);
  out[1] = addc(out[1], carry);
}

// a - b: a borrow takes c off (adds p); if that borrows too, the value is
// at least 2^256 - c and gives up c once more.
__device__ __forceinline__ void fe_sub_lazy(const u32 a[8], const u32 b[8],
                                            u32 out[8]) {
  u32 d[8];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], b[j]);
  u32 borrow = subc(0u, 0u) & 1u;
  out[0] = sub_cc(d[0], borrow * 977u);
  out[1] = subc_cc(d[1], borrow);
#pragma unroll
  for (int j = 2; j < 8; ++j) out[j] = subc_cc(d[j], 0u);
  borrow = subc(0u, 0u) & 1u;
  out[0] = sub_cc(out[0], borrow * 977u);
  out[1] = subc(out[1], borrow);
}
