// Second field core of the kernels: the products mod p on the FP64 pipe.
//
// fe_mul and fe_sqr here take and give the canonical 8 x 32-bit words of
// field.cuh, so tables, sums, differences, selects, loads and stores stay on
// field.cuh; only the product and its reduction move.  An H100 SXM has an
// FP64 unit as wide as its INT32 unit (64 results a clock an SM each), and
// every scheduler can issue to both; field.cuh keeps the FP64 unit idle.
//
// Layout (inside one call only; no value stays in doubles across calls):
// an input w < 2^256 is cut into 11 limbs of 24 bits (the top one 16),
// a = sum a_k 2^(24k), each moved into a double by the 2^52 bit pattern
// (hi word 0x43300000, lo word the limb, one DADD of -2^52).
//
// Exactness: every double here holds an integer below 2^53 and every
// operation's exact result is such an integer, so round-to-nearest never
// rounds, except in `split`, where the rounding is the point:
//   - a product of two limbs is below 2^48, and a column of the schoolbook
//     holds at most 11 of them (< 2^51.5);
//   - the columns at 2^264 and above fold with 2^264 = 2^40 + 250112
//     (mod p), after each is split into h 2^24 + l, |l| <= 2^23, h < 2^28,
//     so every folded term is below 2^46;
//   - `split` adds 1.5 * 2^52 to c / 2^24, where the ulp is 1, so the sum
//     rounds to 1.5 * 2^52 + round(c / 2^24) and h, l follow exactly.
// Only explicit round-to-nearest intrinsics are used (__fma_rn, __dadd_rn,
// __dmul_rn): nvcc must not contract a product and a sum on its own.  A
// plain C++ compiler builds the same arithmetic with std::fma, + and *
// (x86-64 SSE2 rounds to nearest; build without -ffast-math), so the host
// tests check these very operations.
//
// After the fold the 12 columns are carried into signed 24-bit digits (the
// top at 2^240 cut at 16 bits, its carry folded with 2^256 = 2^32 + 977),
// each digit's two's complement read from a double's low word
// (d + 1.5 * 2^52), the borrows taken in integers, the bytes packed into
// words (PRMT), and p added where the value is negative: |value| < p, so
// the result is canonical for any inputs below 2^256.
//
// Bound: FP64 operations.  A product is 121 DFMA for the schoolbook (a
// square 66 DFMA and 11 DADD) and about 150 more FP64 operations (folds,
// splits, conversions), with about 130 integer instructions beside them
// (limbs, borrows, packing, the final add of p): about 380 instructions
// against field.cuh's 220.  On an H100 the two cores issue at the same rate
// (about 57 % of the schedulers' peak at 16 warps an SM), so this one takes
// 1.7x field.cuh's time, and no split of warps between the two cores pays
// (csrc/field_probe.cu, timed by chip_smoke.py).  No kernel of a path uses
// it: FieldF64 below is the point formulas' policy for the probes and the
// host tests.
#pragma once

#include "field.cuh"

#ifndef __CUDACC__
#include <cmath>
#include <cstring>
#endif

namespace f64 {

#ifdef __CUDACC__
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double from_bits(u32 hi, u32 lo) {
  return __hiloint2double((int)hi, (int)lo);
}
__device__ __forceinline__ u32 low_word(double d) {
  return (u32)__double2loint(d);
}
__device__ __forceinline__ u32 funnel_r(u32 lo, u32 hi, u32 s) {
  return __funnelshift_r(lo, hi, s);
}
__device__ __forceinline__ u32 byte_perm(u32 a, u32 b, u32 s) {
  return __byte_perm(a, b, s);
}
#else
inline double fma_rn(double a, double b, double c) {
  return std::fma(a, b, c);
}
inline double add_rn(double a, double b) { return a + b; }
inline double mul_rn(double a, double b) { return a * b; }
inline double from_bits(u32 hi, u32 lo) {
  const u64 bits = ((u64)hi << 32) | lo;
  double d;
  std::memcpy(&d, &bits, sizeof d);
  return d;
}
inline u32 low_word(double d) {
  u64 bits;
  std::memcpy(&bits, &d, sizeof d);
  return (u32)bits;
}
inline u32 funnel_r(u32 lo, u32 hi, u32 s) {
  return (u32)((((u64)hi << 32) | lo) >> (s & 31u));
}
inline u32 byte_perm(u32 a, u32 b, u32 s) {
  const u64 v = ((u64)b << 32) | a;
  u32 r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (u32)((v >> (8 * ((s >> (4 * i)) & 7u))) & 0xFFu) << (8 * i);
  return r;
}
#endif

constexpr double TWO52 = 4503599627370496.0;     // 2^52
constexpr double ROUND = 6755399441055744.0;     // 1.5 * 2^52
constexpr double R24 = 16777216.0;               // 2^24
constexpr double INV_R24 = 1.0 / 16777216.0;
constexpr double R16 = 65536.0;                  // 2^16
constexpr double INV_R16 = 1.0 / 65536.0;
constexpr double FOLD_LO = 250112.0;             // 2^264 = 2^40 + 250112
constexpr double FOLD_HI = 65536.0;              //   2^40 = 2^16 * 2^24
constexpr double FOLD_TOP_LO = 977.0;            // 2^256 = 2^32 + 977
constexpr double FOLD_TOP_HI = 256.0;            //   2^32 = 2^8 * 2^24
constexpr u32 M24 = 0xFFFFFFu;

// The 11 limbs of w as doubles.
__device__ __forceinline__ void to_limbs(const u32 w[8], double x[11]) {
  u32 l[11];
  l[0] = w[0] & M24;
  l[1] = funnel_r(w[0], w[1], 24) & M24;
  l[2] = funnel_r(w[1], w[2], 16) & M24;
  l[3] = w[2] >> 8;
  l[4] = w[3] & M24;
  l[5] = funnel_r(w[3], w[4], 24) & M24;
  l[6] = funnel_r(w[4], w[5], 16) & M24;
  l[7] = w[5] >> 8;
  l[8] = w[6] & M24;
  l[9] = funnel_r(w[6], w[7], 24) & M24;
  l[10] = w[7] >> 16;
#pragma unroll
  for (int k = 0; k < 11; ++k)
    x[k] = add_rn(from_bits(0x43300000u, l[k]), -TWO52);
}

// c = h * 2^24 + l with h = round(c / 2^24), |l| <= 2^23; returns h.
__device__ __forceinline__ double split(double c, double& l) {
  const double h = add_rn(fma_rn(c, INV_R24, ROUND), -ROUND);
  l = fma_rn(h, -R24, c);
  return h;
}

// Column k of the schoolbook x * y added to acc: sum over i + j = k.
template <int K>
__device__ __forceinline__ double column(const double x[11],
                                         const double y[11], double acc) {
#pragma unroll
  for (int i = (K > 10 ? K - 10 : 0); i <= (K < 10 ? K : 10); ++i)
    acc = fma_rn(x[i], y[K - i], acc);
  return acc;
}

// Column k of x^2 (x2 = 2x) added to acc: 2 x_i x_j over i < j, i + j = k,
// and x_(k/2)^2 for even k.
template <int K>
__device__ __forceinline__ double sqr_column(const double x[11],
                                             const double x2[11],
                                             double acc) {
#pragma unroll
  for (int i = (K > 10 ? K - 10 : 0); 2 * i < K; ++i)
    acc = fma_rn(x2[i], x[K - i], acc);
  if (K % 2 == 0) acc = fma_rn(x[K / 2], x[K / 2], acc);
  return acc;
}

// Column k >= 11 (weight 2^(24k) = 2^264 2^(24(k - 11))) folded into
// acc[k - 11 .. k - 9].
template <int K>
__device__ __forceinline__ void fold_column(double c, double acc[12]) {
  double l;
  const double h = split(c, l);
  acc[K - 11] = fma_rn(l, FOLD_LO, acc[K - 11]);
  acc[K - 10] = fma_rn(l, FOLD_HI, fma_rn(h, FOLD_LO, acc[K - 10]));
  acc[K - 9] = fma_rn(h, FOLD_HI, acc[K - 9]);
}

// Canonical words of the value whose columns acc[0..10] (each below 2^52
// in magnitude) and acc[11] (< 2^25) hold.
__device__ __forceinline__ void to_words(double acc[12], u32 out[8]) {
  acc[0] = fma_rn(acc[11], FOLD_LO, acc[0]);
  acc[1] = fma_rn(acc[11], FOLD_HI, acc[1]);
  double d[11];
#pragma unroll
  for (int k = 0; k < 10; ++k)
    acc[k + 1] = add_rn(acc[k + 1], split(acc[k], d[k]));
  // The top digit at 2^240 keeps 16 bits; its carry h at 2^256 folds as
  // h (2^32 + 977) into digits 0 and 1.
  const double h = add_rn(fma_rn(acc[10], INV_R16, ROUND), -ROUND);
  d[10] = fma_rn(h, -R16, acc[10]);
  d[0] = fma_rn(h, FOLD_TOP_LO, d[0]);
  d[1] = fma_rn(h, FOLD_TOP_HI, d[1]);
  double l;
  d[1] = add_rn(d[1], split(d[0], l));
  d[0] = l;
  d[2] = add_rn(d[2], split(d[1], l));
  d[1] = l;
  // Signed digits to words: each digit's two's complement, the borrows
  // (arithmetic shifts), the low 3 bytes of each packed.
  int s[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) s[k] = (int)low_word(add_rn(d[k], ROUND));
#pragma unroll
  for (int k = 1; k < 11; ++k) s[k] += s[k - 1] >> 24;
  u32 w[8];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const u32* u = (const u32*)s + 4 * g;
    w[3 * g] = byte_perm(u[0], u[1], 0x4210u);
    w[3 * g + 1] = byte_perm(u[1], u[2], 0x5421u);
    w[3 * g + 2] = byte_perm(u[2], u[3], 0x6542u);
  }
  w[6] = byte_perm((u32)s[8], (u32)s[9], 0x4210u);
  w[7] = byte_perm((u32)s[9], (u32)s[10], 0x5421u);
  // |value| < p: add p where it is negative (the top digit's sign).
  const u32 neg = (u32)(s[10] >> 31);
  out[0] = add_cc(w[0], ModP::m(0) & neg);
  out[1] = addc_cc(w[1], ModP::m(1) & neg);
#pragma unroll
  for (int k = 2; k < 7; ++k) out[k] = addc_cc(w[k], neg);
  out[7] = addc(w[7], neg);
}

// (a * b) mod p, canonical, for any a, b < 2^256.  The columns are taken
// from the top down, each folded as soon as it is complete, so only the
// limbs and 12 accumulators are live.
__device__ __forceinline__ void fe_mul(const u32 a[8], const u32 b[8],
                                       u32 out[8]) {
  double x[11], y[11], acc[12];
  to_limbs(a, x);
  to_limbs(b, y);
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = 0.0;
  fold_column<20>(mul_rn(x[10], y[10]), acc);
  fold_column<19>(column<19>(x, y, 0.0), acc);
  fold_column<18>(column<18>(x, y, 0.0), acc);
  fold_column<17>(column<17>(x, y, 0.0), acc);
  fold_column<16>(column<16>(x, y, 0.0), acc);
  fold_column<15>(column<15>(x, y, 0.0), acc);
  fold_column<14>(column<14>(x, y, 0.0), acc);
  fold_column<13>(column<13>(x, y, 0.0), acc);
  fold_column<12>(column<12>(x, y, 0.0), acc);
  fold_column<11>(column<11>(x, y, 0.0), acc);
  acc[10] = column<10>(x, y, acc[10]);
  acc[9] = column<9>(x, y, acc[9]);
  acc[8] = column<8>(x, y, acc[8]);
  acc[7] = column<7>(x, y, acc[7]);
  acc[6] = column<6>(x, y, acc[6]);
  acc[5] = column<5>(x, y, acc[5]);
  acc[4] = column<4>(x, y, acc[4]);
  acc[3] = column<3>(x, y, acc[3]);
  acc[2] = column<2>(x, y, acc[2]);
  acc[1] = column<1>(x, y, acc[1]);
  acc[0] = column<0>(x, y, acc[0]);
  to_words(acc, out);
}

// a^2 mod p, canonical, for any a < 2^256.
__device__ __forceinline__ void fe_sqr(const u32 a[8], u32 out[8]) {
  double x[11], x2[11], acc[12];
  to_limbs(a, x);
#pragma unroll
  for (int k = 0; k < 11; ++k) x2[k] = add_rn(x[k], x[k]);
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = 0.0;
  fold_column<20>(mul_rn(x[10], x[10]), acc);
  fold_column<19>(sqr_column<19>(x, x2, 0.0), acc);
  fold_column<18>(sqr_column<18>(x, x2, 0.0), acc);
  fold_column<17>(sqr_column<17>(x, x2, 0.0), acc);
  fold_column<16>(sqr_column<16>(x, x2, 0.0), acc);
  fold_column<15>(sqr_column<15>(x, x2, 0.0), acc);
  fold_column<14>(sqr_column<14>(x, x2, 0.0), acc);
  fold_column<13>(sqr_column<13>(x, x2, 0.0), acc);
  fold_column<12>(sqr_column<12>(x, x2, 0.0), acc);
  fold_column<11>(sqr_column<11>(x, x2, 0.0), acc);
  acc[10] = sqr_column<10>(x, x2, acc[10]);
  acc[9] = sqr_column<9>(x, x2, acc[9]);
  acc[8] = sqr_column<8>(x, x2, acc[8]);
  acc[7] = sqr_column<7>(x, x2, acc[7]);
  acc[6] = sqr_column<6>(x, x2, acc[6]);
  acc[5] = sqr_column<5>(x, x2, acc[5]);
  acc[4] = sqr_column<4>(x, x2, acc[4]);
  acc[3] = sqr_column<3>(x, x2, acc[3]);
  acc[2] = sqr_column<2>(x, x2, acc[2]);
  acc[1] = sqr_column<1>(x, x2, acc[1]);
  acc[0] = sqr_column<0>(x, x2, acc[0]);
  to_words(acc, out);
}

}  // namespace f64

// The point formulas' field operations (point.cuh) with the products on
// the FP64 pipe: sums, differences and products by a word stay on
// field.cuh, every result canonical.
struct FieldF64 {
  __device__ static __forceinline__ void mul(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    f64::fe_mul(a, b, o);
  }
  __device__ static __forceinline__ void sqr(const u32 a[8], u32 o[8]) {
    f64::fe_sqr(a, o);
  }
  __device__ static __forceinline__ void mulw(const u32 a[8], u32 w,
                                              u32 o[8]) {
    fe_mulw<ModP>(a, w, o);
  }
  __device__ static __forceinline__ void add(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_add<ModP>(a, b, o);
  }
  __device__ static __forceinline__ void sub(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_sub<ModP>(a, b, o);
  }
  __device__ static __forceinline__ void canon(const u32 a[8], u32 o[8]) {
    fe_copy(o, a);
  }
};
