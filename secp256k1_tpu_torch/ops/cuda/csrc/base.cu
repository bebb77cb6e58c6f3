// The fixed-base kernels over the affine G table: k_base_final (u1*G + Q,
// public digits) and k_base_scan (k*G, secret digits), below.
//
// base_windowed_add_final: u1*G + Q per lane from signed w-bit window digits
// (w = 8, or 6-15 under SECP256K1_TPU_BASE_WINDOW) and the affine G table,
// in one launch.
//
// Replaces the Pallas kernel base_windowed_add_final
// (secp256k1_tpu/ops/pallas/kernels.py:1070, body
// _base_windowed_add_kernel(signed_digits=True, final_add=True) :959).  The
// TPU version is fed per-window selections made by a bf16 one-hot matmul
// (table.py:199-261), which exists only because TPU matmuls are bf16; here
// the kernel gathers table[w][|d| - 1] itself.  Verify's digits are public,
// so a gather indexed by the digit is fine on this path; the secret-digit
// k_base_scan below selects by a masked scan instead.
//
// Per lane: window 0 is a select ((x, +-y, 1), or the identity (0, 1, 0)
// where the magnitude is 0, even with the sign bit set); each later window is
// a mixed add of the entry, y negated for a set sign bit (bit 16), passed
// through where the magnitude is 0; a complete add of Q ends it.  Digits are
// int32 [W, B], least significant window first; the table is int32
// [W, E, 2, 16] (540 KB for W = 33, E = 128, 6 MB at w = 12, 40 MB at
// w = 15: it stays in L2).
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

// ---------------------------------------------------------------------------
// base_windowed_add: k*G per lane from the window digits of a SECRET scalar
// (an ECDSA nonce, a private key, a BIP-0340 nonce), in one launch.
//
// Replaces the Pallas kernel base_windowed_add
// (secp256k1_tpu/ops/pallas/kernels.py:1041, body
// _base_windowed_add_kernel(signed_digits, final_add=False) :959), in both
// of its modes: signed digits (magnitude (bits 0-15) | sign << 16, tables
// of 2^(w-1) entries a window, widths 6-15) and unsigned digits (in
// [0, 2^w), tables of 2^w - 1 entries, width 8).  The TPU version is fed
// per-window selections from a bf16 one-hot matmul over the whole table
// window; here the kernel selects each window's entry itself by a masked
// scan over all E entries.  Every lane reads every entry of every window in
// the same order, so no load address and no trip count depends on a digit:
// a gather indexed by the digit (k_base_final above) would leak the scalar
// through memory-access timing.
//
// Where the table is read from: a block stages each window's slice of the
// int32 table (16-bit limbs) in shared memory in chunks of at most 128
// entries (16 KB of int32, repacked to 8 KB of 32-bit words), with
// __syncthreads around each chunk, and scans every chunk.  The scan reads
// shared memory by broadcast (all threads of a warp read the same address:
// no bank conflicts), 16 bytes at a time.  Scanning from global memory
// instead would stream the whole table through L2 once per lane.  The
// chunk count is a function of E alone (public).
//
// Per lane: window 0 is a select ((x, +-y, 1), or the identity (0, 1, 0)
// where the magnitude is 0, even with the sign bit set); each later window
// is a mixed add of the entry, y negated for a set sign bit, passed through
// where the magnitude is 0 (the add is computed on every window).
//
// Bound: 32-bit integer operations.  At w = 8 signed, 32 mixed adds are
// ~27,400 32x32-bit products a lane; the scan is 33 x 128 x 16 = 67,584
// masked selects (one LOP3 each) and 16,896 16-byte shared loads a lane,
// which is the larger; the scan grows as W x 2^(w-1) (w = 12: 753,664
// selects a lane).  Bytes are the digits and the three outputs (~330 B a
// lane).
// ---------------------------------------------------------------------------

constexpr int SCAN_CHUNK = 128;      // entries staged at a time
constexpr int SCAN_WORDS = 16;       // x then y, 8 words each
constexpr int SCAN_THREADS = 128;

__global__ void __launch_bounds__(SCAN_THREADS)
    k_base_scan(const int* digits, const int* table, int* ox, int* oy,
                int* oz, int lanes, int n_windows, int n_entries,
                int signed_digits) {
  __shared__ uint4 win[SCAN_CHUNK * SCAN_WORDS / 4];
  u32* words = reinterpret_cast<u32*>(win);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < lanes;
  Pt acc;
  pt_set_identity(acc);

#pragma unroll 1
  for (int w = 0; w < n_windows; ++w) {
    const u32 d = live ? (u32)digits[(size_t)w * lanes + lane] : 0u;
    const u32 mag = signed_digits ? d & 0xFFFFu : d;
    const u32 neg = signed_digits ? (d >> 16) & 1u : 0u;
    u32 x[8], y[8];
    fe_set_small(x, 0);
    fe_set_small(y, 0);
#pragma unroll 1
    for (int c0 = 0; c0 < n_entries; c0 += SCAN_CHUNK) {
      const int count = min(SCAN_CHUNK, n_entries - c0);
      // Stage entries c0 .. c0 + count - 1 of window w: word i of entry
      // e = i / 16 packs limbs 2i, 2i + 1 of the [count, 2, 16] slice (x
      // words 0-7, then y words 0-7).
      __syncthreads();  // the previous chunk's scan is done in every warp
      const int* src = table + ((size_t)w * n_entries + c0) * 2 * 16;
      for (int i = threadIdx.x; i < count * SCAN_WORDS; i += blockDim.x) {
        words[i] =
            (u32)__ldg(src + 2 * i) | ((u32)__ldg(src + 2 * i + 1) << 16);
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < count; ++e) {
        const u32 diff = (u32)(c0 + e + 1) ^ mag;
        const u32 hit = ((diff | (0u - diff)) >> 31) - 1u;  // ~0 iff equal
        const uint4* ent = win + e * (SCAN_WORDS / 4);
        const uint4 a = ent[0], b = ent[1], c = ent[2], f = ent[3];
        x[0] |= a.x & hit; x[1] |= a.y & hit; x[2] |= a.z & hit; x[3] |= a.w & hit;
        x[4] |= b.x & hit; x[5] |= b.y & hit; x[6] |= b.z & hit; x[7] |= b.w & hit;
        y[0] |= c.x & hit; y[1] |= c.y & hit; y[2] |= c.z & hit; y[3] |= c.w & hit;
        y[4] |= f.x & hit; y[5] |= f.y & hit; y[6] |= f.z & hit; y[7] |= f.w & hit;
      }
    }
    u32 ny[8];
    fe_neg<ModP>(y, ny);
    fe_cmov(y, ny, 0u - neg);

    const u32 nonzero = 0u - (u32)(mag != 0u);
    if (w == 0) {
      Pt first;
      fe_copy(first.x, x);
      fe_copy(first.y, y);
      fe_set_small(first.z, 1);
      pt_cmov(acc, first, nonzero);
    } else {
      Pt sum;
      pt_add_mixed(acc, x, y, sum);
      pt_cmov(acc, sum, nonzero);
    }
  }
  if (live) pt_store(ox, oy, oz, lanes, lane, acc);
}

extern "C" int base_windowed_add(const void* digits, const void* table,
                                 void* ox, void* oy, void* oz, int lanes,
                                 int n_windows, int n_entries,
                                 int signed_digits, void* stream) {
  dim3 grid((unsigned)((lanes + SCAN_THREADS - 1) / SCAN_THREADS));
  k_base_scan<<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)digits, (const int*)table, (int*)ox, (int*)oy, (int*)oz,
      lanes, n_windows, n_entries, signed_digits);
  return (int)cudaGetLastError();
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
