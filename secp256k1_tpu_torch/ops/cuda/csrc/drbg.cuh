// RFC 6979's HMAC-SHA256 DRBG for one lane: the per-thread body of
// k_rfc6979 (drbg.cu), written so that a host C++ compiler builds it too
// (tests/test_torch_csrc_host.py holds it against the native library).
//
// SHA-256 per FIPS 180-4 on big-endian 32-bit words; HMAC per RFC 2104.
// A 32-byte HMAC key K enters every HMAC only through the two compressions
// of K ^ ipad and K ^ opad, so those midstates are computed once a key
// (hmac_key) and reused by each HMAC under it: the DRBG of RFC 6979 3.2
// runs two HMACs under each of its keys.  The all-zero key K0 of step c
// has constant midstates (kZeroKeyIn, kZeroKeyOut).  One lane's seeding
// (steps b-g) and first candidate (h) then take 16 compressions, 18 with
// 32 bytes of additional data; each further candidate (h.3, then h.1-2)
// takes 8.
//
// Inside sha256_block the state and the 16-word schedule window are
// registers and the round constants constant-bank operands of the unrolled
// rounds.  sha256_block is not inlined: each kernel calls it from some
// twenty places, which inlined would be some 30,000 instructions; as a
// call, a thread passes its 24 words in and 8 out through its stack.
//
// Secrets: the key x and the nonce.  No branch, trip count or address
// depends on a byte of the data; only the public attempt count and the
// presence of additional data steer control flow.
#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

#ifdef __CUDACC__
#define DRBG_TABLE __constant__
#define DRBG_NOINLINE __noinline__
#else
#define DRBG_TABLE static const
#define DRBG_NOINLINE
#endif

typedef uint32_t u32;

DRBG_TABLE u32 kSha256K[64] = {
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
DRBG_TABLE u32 kSha256IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                               0xa54ff53a, 0x510e527f, 0x9b05688c,
                               0x1f83d9ab, 0x5be0cd19};
// The compressions of 64 bytes of 0x36 and of 0x5c from the IV: the
// midstates of the all-zero key.
DRBG_TABLE u32 kZeroKeyIn[8] = {0xf454dead, 0x9725214f, 0x90daf2a0,
                                0xdf1228ea, 0x64e5750f, 0xa3924181,
                                0x824a932b, 0xf8e04e32};
DRBG_TABLE u32 kZeroKeyOut[8] = {0xd385480f, 0x7abb6477, 0x37c9c538,
                                 0x5dd82467, 0x8e043a72, 0x753434b0,
                                 0xdeb82818, 0x361d45a6};

__device__ __forceinline__ u32 drbg_rotr(u32 x, int n) {
  return (x >> n) | (x << (32 - n));
}

// st = the compression of the 16-word block m from st.
__device__ DRBG_NOINLINE void sha256_block(u32 st[8], const u32 m[16]) {
  u32 w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {  // w[i & 15] becomes word i of the schedule
      const u32 w15 = w[(i + 1) & 15], w2 = w[(i + 14) & 15];
      w[i & 15] += (drbg_rotr(w15, 7) ^ drbg_rotr(w15, 18) ^ (w15 >> 3)) +
                   w[(i + 9) & 15] +
                   (drbg_rotr(w2, 17) ^ drbg_rotr(w2, 19) ^ (w2 >> 10));
    }
    const u32 t1 = h +
                   (drbg_rotr(e, 6) ^ drbg_rotr(e, 11) ^ drbg_rotr(e, 25)) +
                   ((e & f) ^ (~e & g)) + kSha256K[i] + w[i & 15];
    const u32 t2 = (drbg_rotr(a, 2) ^ drbg_rotr(a, 13) ^ drbg_rotr(a, 22)) +
                   ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// (mi, mo): the midstates of the 32-byte key k.
__device__ __forceinline__ void hmac_key(const u32 k[8], u32 mi[8],
                                         u32 mo[8]) {
  u32 bi[16], bo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const u32 w = i < 8 ? k[i] : 0u;
    bi[i] = w ^ 0x36363636u;
    bo[i] = w ^ 0x5c5c5c5cu;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) mi[i] = mo[i] = kSha256IV[i];
  sha256_block(mi, bi);
  sha256_block(mo, bo);
}

// out = HMAC_K of the inner message m (NB blocks after the ipad block,
// padded), K given by its midstates.  out may be an input's storage.
template <int NB>
__device__ __forceinline__ void hmac_finish(const u32 mi[8], const u32 mo[8],
                                            const u32* m, u32 out[8]) {
  u32 ob[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) ob[i] = mi[i];
#pragma unroll
  for (int b = 0; b < NB; ++b) sha256_block(ob, m + 16 * b);
  ob[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) ob[i] = 0u;
  ob[15] = (64 + 32) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = mo[i];
  sha256_block(out, ob);
}

// out = HMAC_K(v).
__device__ __forceinline__ void hmac_v(const u32 mi[8], const u32 mo[8],
                                       const u32 v[8], u32 out[8]) {
  u32 m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = v[i];
  m[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) m[i] = 0u;
  m[15] = (64 + 32) * 8;
  hmac_finish<1>(mi, mo, m, out);
}

// out = HMAC_K(v || sep || d[0] .. d[ND - 1]), sep one byte: every word of
// the message past v straddles two words of the data.
template <int ND>
__device__ __forceinline__ void hmac_v_sep(const u32 mi[8], const u32 mo[8],
                                           const u32 v[8], u32 sep,
                                           const u32* d, u32 out[8]) {
  constexpr int kBytes = 32 + 1 + 4 * ND;          // after the ipad block
  constexpr int kWords = 16 * ((kBytes + 9 + 63) / 64);
  u32 m[kWords];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = v[i];
  u32 prev = sep;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    m[8 + i] = (prev << 24) | (d[i] >> 8);
    prev = d[i];
  }
  m[8 + ND] = (prev << 24) | 0x00800000u;
#pragma unroll
  for (int i = 9 + ND; i < kWords - 1; ++i) m[i] = 0u;
  m[kWords - 1] = (64 + kBytes) * 8;
  hmac_finish<kWords / 16>(mi, mo, m, out);
}

// Candidate `attempt` (0 the first) of the DRBG seeded with the ND words d
// (x || e, 16 words, or x || e || extra, 24), big-endian: RFC 6979 3.2
// steps b-h, then h.3 and h.1-2 for each rejected candidate, as
// libsecp256k1's nonce_function_rfc6979 returns it for counter = attempt.
template <int ND>
__device__ __forceinline__ void rfc6979_lane(const u32* d, int attempt,
                                             u32 out[8]) {
  u32 v[8], k[8], mi[8], mo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = 0x01010101u;
    mi[i] = kZeroKeyIn[i];
    mo[i] = kZeroKeyOut[i];
  }
#pragma unroll 1
  for (u32 sep = 0; sep < 2; ++sep) {      // steps d-e, then f-g
    hmac_v_sep<ND>(mi, mo, v, sep, d, k);  // K = HMAC_K(V || sep || seed)
    hmac_key(k, mi, mo);
    hmac_v(mi, mo, v, v);                  // V = HMAC_K(V)
  }
#pragma unroll 1
  for (int i = 0; i < attempt; ++i) {
    hmac_v(mi, mo, v, v);                  // h.2: a rejected candidate
    hmac_v_sep<0>(mi, mo, v, 0u, d, k);    // h.3: K = HMAC_K(V || 0x00)
    hmac_key(k, mi, mo);
    hmac_v(mi, mo, v, v);                  //      V = HMAC_K(V)
  }
  hmac_v(mi, mo, v, out);                  // h.2: V = HMAC_K(V); T = V
}
