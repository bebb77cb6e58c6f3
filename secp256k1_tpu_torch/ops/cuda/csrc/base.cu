// base_windowed_add_final: u1*G + Q per lane from signed 8-bit window digits
// and the affine G table, in one launch.
//
// Replaces the Pallas kernel base_windowed_add_final
// (secp256k1_tpu/ops/pallas/kernels.py:1070, body
// _base_windowed_add_kernel(signed_digits=True, final_add=True) :959).  The
// TPU version is fed per-window selections made by a bf16 one-hot matmul
// (table.py:199-261), which exists only because TPU matmuls are bf16; here
// the kernel gathers table[w][|d| - 1] itself.  Verify's digits are public,
// so a gather indexed by the digit is fine on this path; the secret-digit
// base_windowed_add of sign and keygen will need a masked scan instead.
//
// Per lane: window 0 is a select ((x, +-y, 1), or the identity (0, 1, 0)
// where the magnitude is 0, even with the sign bit set); each later window is
// a mixed add of the entry, y negated for a set sign bit (bit 16), passed
// through where the magnitude is 0; a complete add of Q ends it.  Digits are
// int32 [W, B], least significant window first; the table is int32
// [W, E, 2, 16] (540 KB for W = 33, E = 128: it stays in L2).
//
// Bound: 32-bit integer multiply-adds.  Per lane 32 mixed adds and one
// complete add, ~365 field multiplies; bytes are the digits, the 3 Q planes
// and the 3 outputs (~330 B a lane) plus one 128-byte table entry per
// window from L2.  Design: one thread per lane, no shared memory.
#include <cuda_runtime.h>

#include "point.cuh"

__device__ __forceinline__ void load_entry(const int* table, int n_entries,
                                           int w, u32 mag, u32 neg, u32 x[8],
                                           u32 y[8]) {
  // Digits come from table._signed_digits (magnitude <= n_entries); the
  // clamp only keeps a malformed digit plane inside the table.
  int e = mag == 0u ? 0 : (int)min(mag, (u32)n_entries) - 1;
  const int* ent = table + ((size_t)w * n_entries + e) * 32;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = (u32)ent[2 * k] | ((u32)ent[2 * k + 1] << 16);
    y[k] = (u32)ent[16 + 2 * k] | ((u32)ent[16 + 2 * k + 1] << 16);
  }
  u32 ny[8];
  fe_neg<ModP>(y, ny);
  fe_cmov(y, ny, 0u - neg);
}

__global__ void k_base_final(const int* digits, const int* table,
                             const int* qx, const int* qy, const int* qz,
                             int* ox, int* oy, int* oz, int lanes,
                             int n_windows, int n_entries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 d = (u32)digits[lane];
  u32 mag = d & 0xFFFFu;
  u32 is0 = 0u - (u32)(mag == 0u);
  Pt acc;
  load_entry(table, n_entries, 0, mag, (d >> 16) & 1u, acc.x, acc.y);
  fe_set_small(acc.z, 1);
  Pt ident;
  fe_set_small(ident.x, 0);
  fe_set_small(ident.y, 1);
  fe_set_small(ident.z, 0);
  pt_cmov(acc, ident, is0);

#pragma unroll 1
  for (int w = 1; w < n_windows; ++w) {
    d = (u32)digits[(size_t)w * lanes + lane];
    mag = d & 0xFFFFu;
    u32 x[8], y[8];
    load_entry(table, n_entries, w, mag, (d >> 16) & 1u, x, y);
    Pt sum;
    pt_add_mixed(acc, x, y, sum);
    pt_cmov(acc, sum, 0u - (u32)(mag != 0u));
  }
  Pt q;
  pt_load(qx, qy, qz, lanes, lane, q);
  pt_add(acc, q, acc);
  pt_store(ox, oy, oz, lanes, lane, acc);
}

extern "C" int base_windowed_add_final(const void* digits, const void* table,
                                       const void* qx, const void* qy,
                                       const void* qz, void* ox, void* oy,
                                       void* oz, int lanes, int n_windows,
                                       int n_entries, void* stream) {
  const int threads = 128;
  dim3 grid((unsigned)((lanes + threads - 1) / threads));
  k_base_final<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)digits, (const int*)table, (const int*)qx, (const int*)qy,
      (const int*)qz, (int*)ox, (int*)oy, (int*)oz, lanes, n_windows,
      n_entries);
  return (int)cudaGetLastError();
}
