// msm_bucket_accumulate_all: Pippenger bucket accumulation for every window
// in one launch.
//
// Replaces the Pallas kernel msm_bucket_accumulate_all
// (secp256k1_tpu/ops/pallas/kernels.py:1232, body _msm_bucket_all_kernel
// :1170).  Inputs: digits int32 [W, N] (0 skips; an unsigned digit d adds
// the point into bucket d - 1; a signed digit is magnitude | sign << 6 and
// negates y first), points (x, y, z) int32 [16, N].  Output: int32
// [W, nb, 3, 16, M] partial buckets.  Slot j of window w holds the sum of the
// points n = j, j + M, j + 2M, ... < N whose digit selects the bucket, added
// in increasing n with the bucket as the first operand of a complete add, as
// the TPU kernel's lane slot j = n mod (blk * 128) does.  Equal projective
// X, Y, Z follow from the same slots, the same order and pt_add's step order.
//
// Uniform schedule, as the TPU kernel's: one thread per (window, slot) walks
// its ceil(N / M) points and does one complete add every step; the bucket is
// selected and written back by a masked select over all nb buckets, so no
// load address, branch or trip count depends on a digit, and a digit of 0
// (or a magnitude above nb) discards the sum.
//
// Where the buckets live: shared memory, private to each thread (nb x 96 B:
// 1,440 B at w = 4, 3,072 B for 32 signed buckets), as word
// ((b * 3 + c) * 8 + k) * T + tid of a block of T threads, so a warp's 32
// threads touch 32 consecutive words (no bank conflict).  T is as large as
// the card's shared memory per block allows, at most 256: 160 threads for 15
// buckets, 128 for 16, 64 for 32.  Global memory would stream every bucket
// through L2 on every step; registers hold a few buckets, not 15.  One pass
// a step merges the write-back of the previous step's sum with the select of
// this step's bucket, so each bucket word is read once and written once a
// step.
//
// Bound, at N = 2^20, w = 4 (W = 64, nb = 15, M = 1024): 64 x 2^20 complete
// adds of 932 32 x 32 -> 64-bit products (point.cuh) are 6.25e10 products,
// 3.7 ms at 132 SMs x 64 a clock x 1.98 GHz; bytes read and written once
// are the digits (268 MB), the points (201 MB) and the buckets (189 MB),
// 0.2 ms at 3.35 TB/s.  So the function is bound by operations.  This design
// re-reads every point once per window (12.9 GB), but threads at the same
// step read the same M points, so the re-reads hit L2; and the bucket pass
// moves 2 x 1,440 B of shared memory per add, 1.9e11 B at 128 B a clock per
// SM, 5.8 ms: the design's own floor lies above the products'.  Measured
// by chip_smoke.py on an H100 80GB HBM3 (700 W): 72 ms, about 20x the
// bound.  Shared memory holds only 160 threads' buckets an SM (5 warps), too
// few to hide the latency of the serial add chains.
#include <cuda_runtime.h>

#include "point.cuh"

constexpr int MSM_MAX_THREADS = 256;
constexpr int PT_WORDS = 24;  // x, y, z of 8 words

__device__ __forceinline__ u32& pt_word(Pt& p, int i) {
  return i < 8 ? p.x[i] : (i < 16 ? p.y[i - 8] : p.z[i - 16]);
}

__global__ void __launch_bounds__(MSM_MAX_THREADS)
    k_msm_buckets(const int* digits, const int* px, const int* py,
                  const int* pz, int* out, int n_windows, int n_points,
                  int n_buckets, int signed_digits, int m_slots) {
  extern __shared__ u32 smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * T + tid;
  if (t >= (long long)n_windows * m_slots) return;  // no barrier below
  const int w = (int)(t / m_slots);
  const int j = (int)(t % m_slots);
  u32* mine = smem + tid;  // word i of bucket b at mine[(b * 24 + i) * T]

#pragma unroll 1
  for (int b = 0; b < n_buckets; ++b) {
#pragma unroll
    for (int i = 0; i < PT_WORDS; ++i)
      mine[(b * PT_WORDS + i) * T] = (i == 8) ? 1u : 0u;  // (0, 1, 0)
  }

  Pt added;  // the previous step's sum, written back in this step's pass
#pragma unroll
  for (int i = 0; i < PT_WORDS; ++i) pt_word(added, i) = 0u;
  u32 prev_mag = 0u;
  const int steps = (n_points + m_slots - 1) / m_slots;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    // The ragged edge (n >= N) reads a real point and counts as digit 0;
    // whether a lane is past the edge depends on n, not on a digit.
    const int n = s * m_slots + j;
    const bool live = n < n_points;
    const int nn = live ? n : n_points - 1;
    u32 d = (u32)digits[(size_t)w * n_points + nn];
    d = live ? d : 0u;
    Pt p;
    pt_load(px, py, pz, n_points, nn, p);
    u32 mag = d;
    if (signed_digits) {
      mag = d & 0x3Fu;
      u32 ny[8];
      fe_neg<ModP>(p.y, ny);
      fe_cmov(p.y, ny, 0u - (u32)((d >> 6) == 1u));
    }

    // One pass over the buckets: bucket b takes the previous sum where the
    // previous digit chose it, and this step's operand is bucket 0 unless
    // the digit chooses another one.
    Pt sel;
#pragma unroll
    for (int i = 0; i < PT_WORDS; ++i) pt_word(sel, i) = 0u;
#pragma unroll 1
    for (int b = 0; b < n_buckets; ++b) {
      const u32 wr = 0u - (u32)(prev_mag == (u32)(b + 1));
      const u32 rd = b == 0 ? ~0u : 0u - (u32)(mag == (u32)(b + 1));
      u32* word = mine + b * PT_WORDS * T;
#pragma unroll
      for (int i = 0; i < PT_WORDS; ++i) {
        u32 v = word[i * T];
        v = (pt_word(added, i) & wr) | (v & ~wr);
        word[i * T] = v;
        pt_word(sel, i) = (v & rd) | (pt_word(sel, i) & ~rd);
      }
    }
    pt_add(sel, p, added);
    prev_mag = mag;
  }

  // Write back the last sum, then store every bucket.
#pragma unroll 1
  for (int b = 0; b < n_buckets; ++b) {
    const u32 wr = 0u - (u32)(prev_mag == (u32)(b + 1));
    u32* word = mine + b * PT_WORDS * T;
    Pt bucket;
#pragma unroll
    for (int i = 0; i < PT_WORDS; ++i)
      pt_word(bucket, i) = (pt_word(added, i) & wr) | (word[i * T] & ~wr);
    int* slab = out + ((size_t)w * n_buckets + b) * 3 * 16 * m_slots;
    store_fe(slab, m_slots, j, bucket.x);
    store_fe(slab + 16 * m_slots, m_slots, j, bucket.y);
    store_fe(slab + 32 * m_slots, m_slots, j, bucket.z);
  }
}

// Threads a block for n_buckets: as many as the shared memory a block may
// use holds, a multiple of 32, at most MSM_MAX_THREADS; 0 if not even 32.
static int msm_threads(int n_buckets, int* smem_bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int per_thread = n_buckets * PT_WORDS * 4;
  int threads = optin / per_thread / 32 * 32;
  if (threads > MSM_MAX_THREADS) threads = MSM_MAX_THREADS;
  *smem_bytes = threads * per_thread;
  return threads;
}

extern "C" int msm_bucket_threads(int n_buckets) {
  int bytes = 0;
  return msm_threads(n_buckets, &bytes);
}

extern "C" int msm_bucket_accumulate_all(const void* digits, const void* px,
                                         const void* py, const void* pz,
                                         void* out, int n_windows,
                                         int n_points, int n_buckets,
                                         int signed_digits, int m_slots,
                                         void* stream) {
  int smem_bytes = 0;
  const int threads = msm_threads(n_buckets, &smem_bytes);
  if (threads < 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k_msm_buckets, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_windows * m_slots;
  dim3 grid((unsigned)((total + threads - 1) / threads));
  k_msm_buckets<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int*)digits, (const int*)px, (const int*)py, (const int*)pz,
      (int*)out, n_windows, n_points, n_buckets, signed_digits, m_slots);
  return (int)cudaGetLastError();
}
