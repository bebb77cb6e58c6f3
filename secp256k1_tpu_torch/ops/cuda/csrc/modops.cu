// mod_mul, mod_square and the exponentiation chain: lane-wise a*b, a^2 and
// a^e mod p or mod n on int32 [16, B] limb planes, for a public constant e.
//
// Replaces the Pallas kernels mod_mul (secp256k1_tpu/ops/pallas/kernels.py
// :1366, _mod_mul_kernel :737), mod_square (:1371, _mod_sqr_kernel :747)
// and mod_pow2k (:784, _mod_pow2k_kernel :756), together with the chain of
// mod_pow2k and mod_mul calls that the JAX ModRing.pow_const_chain
// (secp256k1_tpu/ops/modring.py:204) makes of them for invert (:260), the
// root of invert_batch (:277) and the square root (ops/field.py
// sqrt_ratio).  k_mod_pow_chain runs the whole chain in one launch (steps in
// modops.cuh); a^(2^k) (the wrapper mod_pow2k) is its one-step case.  On
// the TPU the chain's pallas_calls run inside one compiled program; one
// launch a step of it, as eager PyTorch would make them, left the card
// idle between launches of a few squarings each.
//
// Bound: 32-bit integer multiply-adds, not bytes.  Per lane a multiply mod p
// is 64 + 8 + 2 + 2 = 76 wide (32 x 32 -> 64) products, a square 36 + 12, and
// it reads 2 x 64 bytes and writes 64; on an H100 the products take longer
// than the bytes.  The chain keeps its value in registers over all its
// steps (about 255 squarings and 18 to 46 multiplies for p - 2, n - 2 and
// (p - 3)/4), so its bytes are one read and one write a lane.  At full
// width (65,536 lanes) it is bound by those products; at one lane (the
// root of invert_batch) by one thread's latency through the serial chain,
// which no width hides.  The chain's steps, trip counts and slot addresses
// depend on the public exponent only: signing inverts the secret nonce
// through it, and it takes the same time for every input.
//
// Design: one thread per lane, 128 threads a block, no shared memory; the
// ragged edge of B is masked by the lane bound.  k_mod_pow_chain is held to
// 128 registers (four blocks an SM: 65,536 lanes in one wave); its slots
// are in local memory.  The step list (at most POW_MAX_STEPS words) is a
// kernel parameter, copied in by value at each launch.
#include <cuda_runtime.h>

#include <cstring>

#include "modops.cuh"

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

struct PowChain {
  u32 step[POW_MAX_STEPS];
};

template <class M>
__global__ void __launch_bounds__(128, 4)
    k_mod_pow_chain(const int* a, int* out, int lanes, int n_steps,
                    PowChain chain) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 x[8];
  load_fe(a, lanes, lane, x);
  pow_chain<M>(chain.step, n_steps, x);
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

// steps: n_steps host words (1 <= n_steps <= POW_MAX_STEPS), copied into
// the launch's parameters.
extern "C" int mod_pow_chain(const void* a, void* out, const void* steps,
                             int lanes, int n_steps, int mod_id,
                             void* stream) {
  if (n_steps < 1 || n_steps > POW_MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  PowChain chain;
  memset(&chain, 0, sizeof(chain));
  memcpy(chain.step, steps, sizeof(u32) * (size_t)n_steps);
  cudaStream_t s = (cudaStream_t)stream;
  if (mod_id == 0)
    k_mod_pow_chain<ModP><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes, n_steps, chain);
  else
    k_mod_pow_chain<ModN><<<grid_for(lanes), kThreads, 0, s>>>(
        (const int*)a, (int*)out, lanes, n_steps, chain);
  return (int)cudaGetLastError();
}

// Resident blocks of 128 threads an SM of k_mod_pow_chain mod p (mod_id 0)
// or mod n (1); -1 on an error.
extern "C" int pow_chain_blocks_per_sm(int mod_id) {
  int blocks = 0;
  cudaError_t rc =
      mod_id == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_mod_pow_chain<ModP>, kThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_mod_pow_chain<ModN>, kThreads, 0);
  return rc ? -1 : blocks;
}
