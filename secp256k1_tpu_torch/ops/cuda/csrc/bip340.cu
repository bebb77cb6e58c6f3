// k_bip340_challenge: BIP-0340's challenge hash, one thread a lane, the
// first launch of the Schnorr verify core (models/schnorr.py
// `_schnorr_verify_e2e_body`): each lane's
//
//     e = SHA256(t || t || R.x || P.x || m),  t = SHA256("BIP0340/challenge")
//
// as big-endian bytes, not reduced (the core reduces it mod n).
//
// Replaces no TPU kernel: the JAX package hashes the challenge on its host
// (secp256k1_tpu/models/schnorr.py), as the port did with its native
// library (native/hostcrypto.cpp tagged_hash_batch, which signing, the
// object API and the CPU still use).  Run on one host core it held the card
// idle for most of a Taproot verify call; here R.x, P.x and m are already
// byte planes on the card for the core, and e never leaves it.
//
// The 64 bytes t || t are the same in every lane, so their compression
// from the IV is a constant midstate (kChallengeMid).  Each lane then
// compresses R.x || P.x as one block, and m, the 0x80 byte and the 64-bit
// bit length 8 (64 + 64 + L) in ceil((L + 9) / 64) more: 2 for L = 32.
// SHA-256 is drbg.cuh's `sha256_block` (FIPS 180-4), unchanged.
//
// Bound: 32-bit integer operations, about 1,384 a compression as the card
// issues them (profiling.SHA256_BLOCK_OPS); the bytes, 64 + L in and 32 out
// a lane, are far below.  A lane is a serial chain of compressions, so one
// thread takes one lane and the width hides latency.
//
// Layout: uint8 byte planes, r and px [32, B], m [L, B], e [32, B]; row j
// holds byte j of each lane's value (`bt.byte_plane_np`), so a warp's 32
// threads read 32 adjacent bytes of each row.  128 threads a block; the
// ragged edge of B is masked by the lane bound.  Nothing here is secret
// (verify's inputs are public); the trip count depends only on L.
//
// The lane body (above `__CUDACC__`) also builds with a host C++ compiler:
// tests/test_torch_csrc_host.py holds it against the native library.
#include "drbg.cuh"

// The compression of SHA256(tag) || SHA256(tag) from the IV, the tag
// "BIP0340/challenge": the midstate every lane's hash starts from.
DRBG_TABLE u32 kChallengeMid[8] = {0x9cecba11, 0x23925381, 0x11679112,
                                   0xd1627e0f, 0x97c87550, 0x003cc765,
                                   0x90f61164, 0x33e9b66a};

// Bytes 4 w .. 4 w + 3 of the lane's value in `plane`, big-endian.
__device__ __forceinline__ u32 plane_word(const uint8_t* plane, int lanes,
                                          int lane, int w) {
  const uint8_t* p = plane + (size_t)(4 * w) * lanes + lane;
  return (u32)p[0] << 24 | (u32)p[lanes] << 16 | (u32)p[2 * lanes] << 8 |
         (u32)p[3 * (size_t)lanes];
}

// out = the challenge digest of lane `lane` of the planes r, px (32 rows)
// and m (len rows), lanes wide.
__device__ __forceinline__ void bip340_challenge_lane(const uint8_t* r,
                                                      const uint8_t* px,
                                                      const uint8_t* m,
                                                      int lanes, int lane,
                                                      int len, u32 out[8]) {
  u32 w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = kChallengeMid[i];
    w[i] = plane_word(r, lanes, lane, i);
    w[8 + i] = plane_word(px, lanes, lane, i);
  }
  sha256_block(out, w);
  // m || 0x80 || zeros || the bit length in the last 8 bytes.
  const int blocks = (len + 9 + 63) / 64;
  const unsigned long long bits = 8ull * (128 + (unsigned long long)len);
  const uint8_t* mp = m + lane;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u32 word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 64 * b + 4 * k + j;
        const u32 byte = i < len ? (u32)mp[(size_t)i * lanes]
                                 : (i == len ? 0x80u : 0u);
        word = word << 8 | byte;
      }
      w[k] = word;
    }
    if (b == blocks - 1) {  // bytes 56-63 of the last block lie past m
      w[14] = (u32)(bits >> 32);
      w[15] = (u32)bits;
    }
    sha256_block(out, w);
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(128)
    k_bip340_challenge(const uint8_t* r, const uint8_t* px, const uint8_t* m,
                       uint8_t* out, int lanes, int len) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 e[8];
  bip340_challenge_lane(r, px, m, lanes, lane, len, e);
#pragma unroll
  for (int j = 0; j < 32; ++j)
    out[(size_t)j * lanes + lane] = (uint8_t)(e[j >> 2] >> (24 - 8 * (j & 3)));
}

static const int kThreads = 128;

// r, px, out: uint8 [32, lanes] planes; m: uint8 [len, lanes] (not read
// where len is 0).  Each lane's challenge digest into out.
extern "C" int bip340_challenge(const void* r, const void* px, const void* m,
                                void* out, int lanes, int len, void* stream) {
  if (lanes < 1 || len < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_bip340_challenge<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)r, (const uint8_t*)px, (const uint8_t*)m,
      (uint8_t*)out, lanes, len);
  return (int)cudaGetLastError();
}
#endif
