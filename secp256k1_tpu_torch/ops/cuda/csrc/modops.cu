// mod_mul, mod_square and mod_pow2k: lane-wise a*b, a^2 and a^(2^k) mod p or
// mod n on int32 [16, B] limb planes.
//
// Replaces the Pallas kernels mod_mul (secp256k1_tpu/ops/pallas/kernels.py
// :1366, _mod_mul_kernel :737), mod_square (:1371, _mod_sqr_kernel :747) and
// mod_pow2k (:784, _mod_pow2k_kernel :756).
//
// Bound: 32-bit integer multiply-adds, not bytes.  Per lane a multiply mod p
// is 64 + 8 + 2 + 2 = 76 wide (32 x 32 -> 64) products, a square 36 + 12, and
// it reads 2 x 64 bytes and writes 64; on an H100 the products take longer
// than the bytes.  mod_pow2k keeps the value in registers over all k
// squarings, as the Pallas kernel keeps it in VMEM, so its bytes do not
// grow with k.  Design: one thread per lane, 128 threads a block, no shared
// memory; the ragged edge of B is masked by the lane bound.
#include <cuda_runtime.h>

#include "field.cuh"

template <class M>
__global__ void k_mod_mul(const int* a, const int* b, int* out, int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 x[8], y[8], r[8];
  load_fe(a, lanes, lane, x);
  load_fe(b, lanes, lane, y);
  fe_mul<M>(x, y, r);
  store_fe(out, lanes, lane, r);
}

template <class M>
__global__ void k_mod_square(const int* a, int* out, int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 x[8], r[8];
  load_fe(a, lanes, lane, x);
  fe_sqr<M>(x, r);
  store_fe(out, lanes, lane, r);
}

template <class M>
__global__ void k_mod_pow2k(const int* a, int* out, int lanes, int k) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 x[8];
  load_fe(a, lanes, lane, x);
#pragma unroll 1
  for (int i = 0; i < k; ++i) fe_sqr<M>(x, x);
  store_fe(out, lanes, lane, x);
}

static const int kThreads = 128;

static inline dim3 grid_for(int lanes) {
  return dim3((unsigned)((lanes + kThreads - 1) / kThreads));
}

extern "C" int mod_mul(const void* a, const void* b, void* out, int lanes,
                       int mod_id, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mod_id == 0)
    k_mod_mul<ModP><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (const int*)b, (int*)out, lanes);
  else
    k_mod_mul<ModN><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (const int*)b, (int*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int mod_square(const void* a, void* out, int lanes, int mod_id,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mod_id == 0)
    k_mod_square<ModP><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes);
  else
    k_mod_square<ModN><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int mod_pow2k(const void* a, void* out, int lanes, int k,
                         int mod_id, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mod_id == 0)
    k_mod_pow2k<ModP><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes, k);
  else
    k_mod_pow2k<ModN><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes, k);
  return (int)cudaGetLastError();
}
