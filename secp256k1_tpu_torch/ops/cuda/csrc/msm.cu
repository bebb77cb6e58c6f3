// msm_bucket_accumulate_all: Pippenger bucket accumulation for every window
// in one launch; and msm_fold, the Horner fold of the window sums in one
// launch (k_msm_fold, at the end of this file).
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
// A bucket is addressed by its digit, and this kernel alone among the
// port's kernels lets a digit choose an address, a branch and the number of
// adds: MSM's scalars are public (batch verification, commitments, key
// aggregation: no caller passes a secret), and the JAX package's own
// non-Pallas path orders the points by their digits (ops/msm.py
// _bucket_accumulate).  The TPU kernel's masked pass over every bucket
// exists only because Mosaic has no scatter.  The secret-digit kernels
// keep reading every entry: GLV and point_lookup_add by masked scans,
// k_base_scan by a one-hot product on the tensor cores.  A
// magnitude of 0 or above nb is discarded by a bounds check before any
// bucket is read: no address outside the slot's nb buckets is formed.
//
// Design: one thread per (window, slot), 128 threads a block, at most 128
// registers a thread (four blocks an SM: all 65,536 threads of a 64-window
// MSM resident at once).  Each step reads the slot's digit and, for a
// digit in [1, nb], the point (coalesced: adjacent threads take adjacent
// n), the one bucket (96 B), one complete add, and writes that bucket
// back.  The buckets live in a device-memory scratch buffer the wrapper
// allocates, each (thread, bucket) record 96 contiguous bytes read and
// written as six 16-byte vectors: W x M x nb x 96 B (94 MB at w = 4), so
// registers, not bucket storage, set the occupancy.  The design it
// replaced kept every slot's buckets in shared memory and merged a masked
// write-back and select over all nb buckets into each step: 2 x nb x 96 B
// of shared traffic an add, and room for only 160 threads an SM at
// nb = 15 (five warps, too few to hide the serial add chain): 71.9 ms at
// 2^20 points, w = 4 on an H100 80GB HBM3 at 700 W; this design about
// 15 ms there.  The same walk with the buckets indexed in that
// shared-memory layout (word (b * 24 + i) * T + tid: each thread owns a
// bank whatever b is) was measured and dropped: 26.48 ms there, its
// occupancy still set by the buckets (chip_smoke.py, PERF.md).  The walk
// itself is in msm.cuh.
//
// Bound, at N = 2^20, w = 4 (W = 64, nb = 15, M = 1024): one complete add
// of 932 32 x 32 -> 64-bit products (point.cuh) per nonzero digit, about
// 6.3e10 products, 3.5 ms at 132 SMs x 64 a clock x 1.98 GHz; bytes read
// and written once are the digits (268 MB), the points (201 MB) and the
// buckets (189 MB), 0.2 ms at 3.35 TB/s.  So the function is bound by
// operations.  This design adds its own traffic: every window's thread
// reads the point (12.9 GB from L2 at 2^20) and each add moves a 96 B
// bucket each way (12.9 GB, most of it to HBM: the scratch exceeds L2).
#include <cuda_runtime.h>

#include "msm.cuh"

constexpr int MSM_THREADS = 128;
constexpr int MSM_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(MSM_THREADS, MSM_MIN_BLOCKS)
    k_msm_buckets(const int* digits, const int* px, const int* py,
                  const int* pz, uint4* scratch, int* out, int n_windows,
                  int n_points, int n_buckets, int signed_digits,
                  int m_slots) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_windows * m_slots) return;
  msm_walk(scratch + (size_t)t * n_buckets * 6, digits, px, py, pz, out,
           (int)(t / m_slots), (int)(t % m_slots), n_points, n_buckets,
           signed_digits, m_slots);
}

// scratch: n_windows * m_slots * n_buckets * 96 bytes, 16-byte aligned.
extern "C" int msm_bucket_accumulate_all(const void* digits, const void* px,
                                         const void* py, const void* pz,
                                         void* scratch, void* out,
                                         int n_windows, int n_points,
                                         int n_buckets, int signed_digits,
                                         int m_slots, void* stream) {
  const long long total = (long long)n_windows * m_slots;
  dim3 grid((unsigned)((total + MSM_THREADS - 1) / MSM_THREADS));
  k_msm_buckets<<<grid, MSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)digits, (const int*)px, (const int*)py, (const int*)pz,
      (uint4*)scratch, (int*)out, n_windows, n_points, n_buckets,
      signed_digits, m_slots);
  return (int)cudaGetLastError();
}

// k_msm_fold: combine_windows (ops/msm.py) in one launch of one warp.
//
// Replaces the fold of the JAX package's combine_windows
// (secp256k1_tpu/ops/msm.py:297, a lax.scan of window_bits point_double
// and one point_add a window, the Pallas kernels point_double and
// point_add: secp256k1_tpu/ops/pallas/kernels.py:1380, :1376).  On the TPU
// the scan runs inside one compiled program; as one launch a point
// operation (256 point_double and 64 point_add launches of one lane at
// w = 4, W = 64) it left the card idle between launches.  Any W and
// window_bits (W = 64, w = 4 and W = 53, w = 5 on the bucket path; W = 32,
// w = 8 on sort + scan).
//
// Bound: latency.  The fold is serial: 256 doublings and 64 complete adds
// (at w = 4, W = 64), each a dependent chain of field operations; the
// card's product rate and its bytes (W x 192 B in, 192 B out) would take
// well under a microsecond.  One thread took 2.8 us a point operation
// (every product of a formula in turn); here the lanes of one warp share
// each formula, so a doubling costs two products' latency and an add two,
// with the sums and differences between them (msm.cuh).  Six lanes work;
// the window's sum is read a window ahead, during the doublings.  The
// output is the projective X, Y, Z of the launches it replaces.
__global__ void __launch_bounds__(32)
    k_msm_fold(const int* rows, int* ox, int* oy, int* oz, int n_windows,
               int window_bits) {
  __shared__ u32 reg[FOLD_REGS][8];
  // The programs, staged so that each lane reads its own step of a round
  // from its own bank (from constant memory six lanes' distinct steps
  // would be read one after another).
  __shared__ FoldStep prog[2][FOLD_ROUNDS][FOLD_WIDTH];
  const int t = threadIdx.x;
  for (int i = t; i < FOLD_ROUNDS * FOLD_WIDTH; i += 32) {
    prog[0][i / FOLD_WIDTH][i % FOLD_WIDTH] =
        kFoldDouble[i / FOLD_WIDTH][i % FOLD_WIDTH];
    prog[1][i / FOLD_WIDTH][i % FOLD_WIDTH] =
        kFoldAdd[i / FOLD_WIDTH][i % FOLD_WIDTH];
  }
  // Lane t < 24 holds word t % 8 of coordinate t / 8 of the point it
  // loads or stores.
  const int c = t / 8, k = t % 8;
  if (t < 24) reg[FX + c][k] = t == 8 ? 1u : 0u;  // the identity (0, 1, 0)
  __syncwarp();
  for (int i = n_windows - 1; i >= 0; --i) {
    u32 q = 0;
    if (t < 24) {
      const int* limb = rows + (size_t)i * 48 + 16 * c + 2 * k;
      q = (u32)limb[0] | ((u32)limb[1] << 16);
    }
#pragma unroll 1
    for (int d = 0; d < window_bits; ++d) {
#pragma unroll 1
      for (int r = 0; r < FOLD_ROUNDS; ++r) {
        if (t < FOLD_WIDTH) fold_step(reg, prog[0][r][t]);
        __syncwarp();
      }
    }
    if (t < 24) reg[FQX + c][k] = q;
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < FOLD_ROUNDS; ++r) {
      if (t < FOLD_WIDTH) fold_step(reg, prog[1][r][t]);
      __syncwarp();
    }
  }
  if (t < 24) {
    int* out = (c == 0 ? ox : c == 1 ? oy : oz) + 2 * k;
    out[0] = (int)(reg[FX + c][k] & 0xFFFFu);
    out[1] = (int)(reg[FX + c][k] >> 16);
  }
}

// rows: int32 [n_windows, 3, 16]; ox, oy, oz: int32 [16, 1].
extern "C" int msm_fold(const void* rows, void* ox, void* oy, void* oz,
                        int n_windows, int window_bits, void* stream) {
  k_msm_fold<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (int*)ox, (int*)oy, (int*)oz, n_windows,
      window_bits);
  return (int)cudaGetLastError();
}
