// k_expand_xmd: RFC 9380 section 5.3.1 expand_message_xmd with SHA-256,
// one thread a lane, the first launch of the hash-to-curve cores
// (models/h2c.py `_ro_bytes_core`, `_nu_bytes_core`): each lane's
//
//     b0 = H(Z_pad || msg || I2OSP(n_out, 2) || 0x00 || DST')
//     b1 = H(b0 || 0x01 || DST')
//     bi = H((b0 ^ b(i-1)) || I2OSP(i, 1) || DST'),  i = 2 .. ell
//
// and the first n_out bytes of b1 || ... || b_ell, the uniform strings the
// SWU map reads.
//
// Replaces no TPU kernel: the JAX package expands on its host
// (secp256k1_tpu/models/h2c.py), as the port did with its native library
// (h2c.expand_message_xmd_batch, one native SHA-256 call a stage, which the
// list entry points, the plain version and the CPU still use).  Run on one
// host core it held the card idle for most of a hash-to-curve call.
//
// Z_pad, 64 zero bytes, is the same in every lane, so its compression from
// the IV is a constant midstate (kZpadMid).  Each lane then compresses its
// message and b0's tail, the 0x80 byte and the 64-bit bit length in
// ceil((len + 3 + |DST'| + 9) / 64) blocks, its own count (1 to 3 for 0 to
// 128 bytes under the suites' 50-byte DST', 10 for 517 bytes); each b_i
// takes ceil((33 + |DST'| + 9) / 64) more, 2 under that DST', the same in
// every lane.  SHA-256 is drbg.cuh's `sha256_block` (FIPS 180-4),
// unchanged.
//
// Bound: 32-bit integer operations, about 1,384 a compression as the card
// issues them (profiling.SHA256_BLOCK_OPS); the bytes, a message and
// n_out a lane, are far below.  A lane is a serial chain of compressions,
// so one thread takes one lane and the width hides latency; a warp runs as
// many b0 blocks as its longest message needs.
//
// Layout: the messages as the caller holds them, rows [n, width] uint8
// row-major (lane i's message the first lens[i] bytes of row i), lens [n]
// int32; no host transpose.  Out: uint8 [48, (n_out / 48) lanes], byte j
// of lane i's string at row j % 48, column (j / 48) lanes + i: for n_out
// = 96 u0's plane in lanes 0 .. lanes - 1 and u1's beside it, the [48, 2B]
// plane the random-oracle suite's two maps read side by side.  Lanes n to
// lanes - 1 repeat lane n - 1 (`bt.byte_plane_np`'s padding).  DST' (2 to
// 256 bytes) is a kernel argument; the block copies b0's tail
// I2OSP(n_out, 2) || 0x00 || DST' into shared memory once.  The oversize-DST
// reduction and the RFC's rejections stay with the caller.  Nothing here is
// secret to the card's other users; the trip count depends on each lane's
// length, which RFC 9380's SHA-256 reveals anyway.
//
// The lane body (above `__CUDACC__`) also builds with a host C++ compiler:
// tests/test_torch_csrc_host.py holds it against the JAX package's
// expand_message_xmd.
#include "drbg.cuh"

// The bytes of one field element's uniform string (RFC 9380's L for
// secp256k1): the output's rows.
static const int kXmdPart = 48;
// DST' bytes at most (a DST of 255 bytes and its length byte), and b0's
// tail at most.
static const int kXmdMaxDst = 256;
static const int kXmdMaxTail = 3 + kXmdMaxDst;

// The compression of Z_pad (64 zero bytes) from the IV: the midstate every
// lane's b0 starts from.
DRBG_TABLE u32 kZpadMid[8] = {0xda5698be, 0x17b9b469, 0x62335799,
                              0x779fbeca, 0x8ce5d491, 0xc0d26243,
                              0xbafef9ea, 0x1837a9d8};

// Byte t of b0's tail I2OSP(n_out, 2) || 0x00 || DST'.
__device__ __forceinline__ uint8_t xmd_tail_byte(const uint8_t* dst_prime,
                                                 int n_out, int t) {
  if (t == 0) return (uint8_t)(n_out >> 8);
  if (t == 1) return (uint8_t)n_out;
  return t == 2 ? (uint8_t)0 : dst_prime[t - 3];
}

// The n_out bytes of expand_message_xmd of msg (its first len bytes) under
// tail (b0's tail, 3 + dst_len bytes; DST' is tail + 3): byte j into
// out[(j % kXmdPart) * stride + (j / kXmdPart) * lanes], out already at the
// lane's column.
__device__ __forceinline__ void expand_xmd_lane(const uint8_t* msg, int len,
                                                const uint8_t* tail,
                                                int dst_len, int n_out,
                                                uint8_t* out, int lanes,
                                                size_t stride) {
  u32 b0[8], w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) b0[i] = kZpadMid[i];
  // b0: msg || tail || 0x80 || zeros || the bit length in the last 8 bytes.
  const int total = len + 3 + dst_len;
  const int blocks = (total + 9 + 63) / 64;
  const unsigned long long bits = 8ull * (64 + (unsigned long long)total);
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u32 word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 64 * b + 4 * k + j;
        u32 byte;
        if (p < len) byte = msg[p];
        else if (p < total) byte = tail[p - len];
        else byte = p == total ? 0x80u : 0u;
        word = word << 8 | byte;
      }
      w[k] = word;
    }
    if (b == blocks - 1) {  // bytes 56-63 of the last block lie past the tail
      w[14] = (u32)(bits >> 32);
      w[15] = (u32)bits;
    }
    sha256_block(b0, w);
  }
  // b_i: (b0 ^ b(i-1)) || i || DST' || 0x80 || zeros || the bit length;
  // b1 hashes b0 itself (b(0) taken as zero).
  const uint8_t* dst = tail + 3;
  const int bi_total = 33 + dst_len;
  const int bi_blocks = (bi_total + 9 + 63) / 64;
  const unsigned long long bi_bits = 8ull * (unsigned long long)bi_total;
  const int ell = (n_out + 31) / 32;
  u32 prev[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) prev[k] = 0u;
#pragma unroll 1
  for (int i = 1; i <= ell; ++i) {
    u32 st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      st[k] = kSha256IV[k];
      w[k] = b0[k] ^ prev[k];
    }
#pragma unroll 1
    for (int b = 0; b < bi_blocks; ++b) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (b == 0 && k < 8) continue;  // b0 ^ b(i-1)
        u32 word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 64 * b + 4 * k + j;
          u32 byte;
          if (p == 32) byte = (u32)i;
          else if (p < bi_total) byte = dst[p - 33];
          else byte = p == bi_total ? 0x80u : 0u;
          word = word << 8 | byte;
        }
        w[k] = word;
      }
      if (b == bi_blocks - 1) {
        w[14] = (u32)(bi_bits >> 32);
        w[15] = (u32)bi_bits;
      }
      sha256_block(st, w);
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int j = 32 * (i - 1) + t;
      if (j < n_out)
        out[(size_t)(j % kXmdPart) * stride + (size_t)(j / kXmdPart) * lanes] =
            (uint8_t)(st[t >> 2] >> (24 - 8 * (t & 3)));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) prev[k] = st[k];
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <cstring>

// DST', passed by value.
struct XmdDst {
  uint8_t b[kXmdMaxDst];
};

__global__ void __launch_bounds__(128)
    k_expand_xmd(const uint8_t* __restrict__ rows,
                 const int* __restrict__ lens, uint8_t* __restrict__ out,
                 const XmdDst dst, int dst_len, int n, int width, int lanes,
                 int n_out) {
  __shared__ uint8_t tail[kXmdMaxTail];
  for (int t = threadIdx.x; t < 3 + dst_len; t += blockDim.x)
    tail[t] = xmd_tail_byte(dst.b, n_out, t);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int src = lane < n ? lane : n - 1;
  // The caller checks the lengths; clamped, no read leaves the row.
  const int len = min(max(lens[src], 0), width);
  expand_xmd_lane(rows + (size_t)src * width, len, tail, dst_len, n_out,
                  out + lane, lanes, (size_t)(n_out / kXmdPart) * lanes);
}

static const int kThreads = 128;

// rows: uint8 [n, width] on the card; lens: int32 [n] on the card;
// dst_prime: dst_len (2 to 256) bytes in host memory; out: uint8
// [48, (n_out / 48) lanes] on the card, n_out a multiple of 48 up to 8,160
// (ell <= 255); 1 <= n <= lanes.
extern "C" int expand_xmd(const void* rows, const void* lens,
                          const void* dst_prime, void* out, int dst_len,
                          int n, int width, int lanes, int n_out,
                          void* stream) {
  if (lanes < 1 || n < 1 || n > lanes || width < 0 || dst_len < 2 ||
      dst_len > kXmdMaxDst || n_out < kXmdPart || n_out > 255 * 32 ||
      n_out % kXmdPart)
    return (int)cudaErrorInvalidValue;
  XmdDst d;
  memset(d.b, 0, sizeof(d.b));
  memcpy(d.b, dst_prime, (size_t)dst_len);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_expand_xmd<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)rows, (const int*)lens, (uint8_t*)out, d, dst_len, n,
      width, lanes, n_out);
  return (int)cudaGetLastError();
}
#endif
