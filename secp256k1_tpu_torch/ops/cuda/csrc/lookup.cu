// point_lookup_add: the GLV window body after the doublings, per lane: a
// masked select of table[d - 1] from the lane's own 15-entry table, a
// complete add into the accumulator, and the accumulator passed through
// where the digit is 0.  Canonical X, Y, Z out.
//
// Replaces the Pallas kernel point_lookup_add (secp256k1_tpu/ops/pallas/
// kernels.py:1388, plookup_add :1330), the lookup of the not-mega GLV loop
// (SECP256K1_TPU_MEGA=0, ops/glv.py).  Its digits are the nibbles of a
// secret scalar on the ECDH path, so every lane reads all 15 entries in the
// same order: no load address, branch or trip count depends on the digit
// (LaneTable::scan of point.cuh).  The table is int32 [15, 3, 16, B],
// lane-minor, so each of the 720 limb rows is one coalesced read a warp.
//
// Bound: bytes.  Per lane the 15 x 48 table words (2,880 B), the 3 input
// and 3 output planes (384 B) and the digit: 3,268 B, against one complete
// add (932 32 x 32-bit products).  Design: one thread per lane, 128 threads
// a block, no shared memory (nothing is reused between lanes); any B, the
// ragged edge masked by the lane bound.
#include <cuda_runtime.h>

#include "point.cuh"

__global__ void k_lookup_add(const int* x, const int* y, const int* z,
                             const int* table, const int* digits, int* ox,
                             int* oy, int* oz, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt acc, sel;
  pt_load(x, y, z, lanes, lane, acc);
  const u32 d = (u32)digits[lane];
  fe_set_small(sel.x, 0);
  fe_set_small(sel.y, 0);
  fe_set_small(sel.z, 0);
  const LaneTable<15> tab{table, lanes, lane};
  tab.scan(d, sel);
  Pt sum;
  pt_add(acc, sel, sum);
  pt_cmov(acc, sum, 0u - (u32)(d != 0u));
  pt_store(ox, oy, oz, lanes, lane, acc);
}

extern "C" int point_lookup_add(const void* x, const void* y, const void* z,
                                const void* table, const void* digits,
                                void* ox, void* oy, void* oz, int lanes,
                                void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((lanes + threads - 1) / threads));
  k_lookup_add<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)y, (const int*)z, (const int*)table,
      (const int*)digits, (int*)ox, (int*)oy, (int*)oz, lanes);
  return (int)cudaGetLastError();
}
