// glv_windowed_mult_signed: k1*P1 + k2*P2 per lane from signed 4-bit window
// digits, the whole GLV double-and-add loop in one launch.
//
// Replaces the Pallas kernel glv_windowed_mult_signed_from_points
// (secp256k1_tpu/ops/pallas/kernels.py:1135, body
// _glv_mega_frompoints_kernel(signed_digits=True, n_entries=8) :850).
//
// Per lane: build the tables [P, 2P, .., 8P] for both points (1 doubling and
// 6 complete adds each); window 0 selects from table 1 (the whole identity
// (0, 1, 0) where the magnitude is 0, even with the sign bit set) and adds
// from table 2; each of the 32 later windows does 4 doublings and 2
// lookup-adds.  A lookup is a masked scan over all 8 entries, never an index
// by the digit: ECDH will feed secret scalars to this kernel.  A set sign bit
// (bit 4) negates the selected y; magnitude 0 passes the accumulator through.
// Digits are int32 [33, B], most significant window first.
//
// Bound: 32-bit integer multiply-adds.  Per lane 2 x 7 table points and 65
// lookup-adds and 128 doublings: ~1,800 field multiplies of ~76 wide products
// each; the 9 input and 3 output planes are ~1 KB a lane.  Design: one thread
// per lane; the two tables (2 x 8 x 24 words = 1.5 KB a lane) live in local
// memory (L1/L2), because registers cannot hold them and shared memory would
// cap a block at ~100 lanes; the window and step loops are not unrolled, so
// one copy each of the add and the doubling is compiled.
#include <cuda_runtime.h>

#include "point.cuh"

__device__ __forceinline__ void select_entry(const Pt tab[8], int d, Pt& sel,
                                             u32& mag) {
  mag = (u32)d & 0xFu;
  fe_set_small(sel.x, 0);
  fe_set_small(sel.y, 0);
  fe_set_small(sel.z, 0);
#pragma unroll 1
  for (int e = 0; e < 8; ++e) {
    u32 mask = 0u - (u32)(mag == (u32)(e + 1));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sel.x[k] |= tab[e].x[k] & mask;
      sel.y[k] |= tab[e].y[k] & mask;
      sel.z[k] |= tab[e].z[k] & mask;
    }
  }
  u32 ny[8];
  fe_neg<ModP>(sel.y, ny);
  fe_cmov(sel.y, ny, 0u - (((u32)d >> 4) & 1u));
}

__device__ __forceinline__ void lookup_add(Pt& acc, const Pt tab[8], int d) {
  Pt sel;
  u32 mag;
  select_entry(tab, d, sel, mag);
  Pt sum;
  pt_add(acc, sel, sum);
  pt_cmov(acc, sum, 0u - (u32)(mag != 0u));
}

__global__ void k_glv_signed(const int* d1, const int* d2, const int* p1x,
                             const int* p1y, const int* p1z, const int* p2x,
                             const int* p2y, const int* p2z, int* ox,
                             int* oy, int* oz, int lanes, int n_windows) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt tab[2][8];
  pt_load(p1x, p1y, p1z, lanes, lane, tab[0][0]);
  pt_load(p2x, p2y, p2z, lanes, lane, tab[1][0]);
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    pt_double(tab[t][0], tab[t][1]);
#pragma unroll 1
    for (int e = 2; e < 8; ++e) pt_add(tab[t][e - 1], tab[t][0], tab[t][e]);
  }

  // Window 0: a select from table 1, then a lookup-add from table 2.
  Pt acc;
  u32 mag0;
  select_entry(tab[0], d1[lane], acc, mag0);
  u32 one[8];
  fe_set_small(one, 1);
  fe_cmov(acc.y, one, 0u - (u32)(mag0 == 0u));
  lookup_add(acc, tab[1], d2[lane]);

#pragma unroll 1
  for (int w = 1; w < n_windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt_double(acc, acc);
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      const int* d = t == 0 ? d1 : d2;
      lookup_add(acc, tab[t], d[(size_t)w * lanes + lane]);
    }
  }
  pt_store(ox, oy, oz, lanes, lane, acc);
}

extern "C" int glv_windowed_mult_signed(
    const void* d1, const void* d2, const void* p1x, const void* p1y,
    const void* p1z, const void* p2x, const void* p2y, const void* p2z,
    void* ox, void* oy, void* oz, int lanes, int n_windows, void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((lanes + threads - 1) / threads));
  k_glv_signed<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)p1x, (const int*)p1y,
      (const int*)p1z, (const int*)p2x, (const int*)p2y, (const int*)p2z,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}
