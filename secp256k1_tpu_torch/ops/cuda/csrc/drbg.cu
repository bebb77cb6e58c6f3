// k_rfc6979: RFC 6979's HMAC-SHA256 DRBG, one thread a lane, the first
// launch of the ECDSA sign core (models/ecdsa.py `_sign_e2e_core`): each
// lane's nonce candidate from its key and reduced digest, and 32 bytes of
// additional data where given (RFC 6979 3.6, appended to the seed as
// libsecp256k1's nonce_function_rfc6979 appends its data).
//
// Replaces no TPU kernel: the JAX package derives its nonces on the host
// (secp256k1_tpu/native/hostcrypto.cpp), as the port did with its copy
// (native/hostcrypto.cpp rfc6979_nonce_batch, which sign_batch's per-lane
// readers and the tests still use).  Run on one host core it held the card
// idle for most of a signing call; here the keys and digests are already on
// the card for the sign core, and the nonce never leaves it.
//
// Bound: 32-bit integer operations (drbg.cuh): 16 SHA-256 compressions a
// lane (18 with additional data) and 8 more for each further candidate, of
// about 1,384 operations each as the card issues them (rotations as funnel
// shifts, three-input LOP3 and IADD3).  The bytes are 64 or 96 in and 32
// out a lane, far below.  The per-lane work is a serial chain of
// compressions, so one thread takes one lane and the width hides latency.
//
// Layout: uint8 [32, B] byte planes, row j byte j of each lane's
// big-endian value (`bt.byte_plane_np`), so a warp's 32 threads read 32
// adjacent bytes of each row.  128 threads a block; the ragged edge of B
// is masked by the lane bound.  The seed's width is a template argument,
// so a launch without additional data reads no third plane.
#include <cuda_runtime.h>

#include "drbg.cuh"

__device__ __forceinline__ void load_words(const uint8_t* plane, int lanes,
                                           int lane, u32* w) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint8_t* p = plane + (size_t)(4 * j) * lanes + lane;
    w[j] = (u32)p[0] << 24 | (u32)p[lanes] << 16 | (u32)p[2 * lanes] << 8 |
           (u32)p[3 * (size_t)lanes];
  }
}

template <int ND>
__global__ void __launch_bounds__(128)
    k_rfc6979(const uint8_t* x, const uint8_t* e, const uint8_t* extra,
              uint8_t* out, int lanes, int attempt) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 d[ND], t[8];
  load_words(x, lanes, lane, d);
  load_words(e, lanes, lane, d + 8);
  if constexpr (ND == 24) load_words(extra, lanes, lane, d + 16);
  rfc6979_lane<ND>(d, attempt, t);
#pragma unroll
  for (int j = 0; j < 32; ++j)
    out[(size_t)j * lanes + lane] = (uint8_t)(t[j >> 2] >> (24 - 8 * (j & 3)));
}

static const int kThreads = 128;

// x, e, extra, out: uint8 [32, lanes] planes (extra read only where
// has_extra); candidate `attempt` of each lane's DRBG into out.
extern "C" int rfc6979_nonce(const void* x, const void* e, const void* extra,
                             void* out, int lanes, int attempt, int has_extra,
                             void* stream) {
  if (lanes < 1 || attempt < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  if (has_extra)
    k_rfc6979<24><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)x, (const uint8_t*)e, (const uint8_t*)extra,
        (uint8_t*)out, lanes, attempt);
  else
    k_rfc6979<16><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)x, (const uint8_t*)e, nullptr, (uint8_t*)out, lanes,
        attempt);
  return (int)cudaGetLastError();
}
