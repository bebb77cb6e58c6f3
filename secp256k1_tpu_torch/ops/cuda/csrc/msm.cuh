// The bucket walk of k_msm_buckets (msm.cu): one slot of one window, its
// buckets addressed by the digit, in device memory.  See msm.cu for the
// design.  A plain C++ compiler builds it too (uint4 below), so the CPU
// tests can walk it against the plain version.
#pragma once

#include "point.cuh"

#ifndef __CUDACC__
struct uint4 {
  u32 x, y, z, w;
};
inline uint4 make_uint4(u32 x, u32 y, u32 z, u32 w) { return {x, y, z, w}; }
#endif

constexpr int PT_WORDS = 24;  // x, y, z of 8 words

__device__ __forceinline__ u32& pt_word(Pt& p, int i) {
  return i < 8 ? p.x[i] : (i < 16 ? p.y[i - 8] : p.z[i - 16]);
}

// Bucket b of a thread's records (rec: the thread's nb buckets, 96
// contiguous bytes each), read and written as six 16-byte vectors.
__device__ __forceinline__ void bucket_load(const uint4* rec, int b, Pt& p) {
  const uint4* r = rec + 6 * b;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const uint4 v = r[q];
    pt_word(p, 4 * q) = v.x;
    pt_word(p, 4 * q + 1) = v.y;
    pt_word(p, 4 * q + 2) = v.z;
    pt_word(p, 4 * q + 3) = v.w;
  }
}

__device__ __forceinline__ void bucket_store(uint4* rec, int b, Pt& p) {
  uint4* r = rec + 6 * b;
#pragma unroll
  for (int q = 0; q < 6; ++q)
    r[q] = make_uint4(pt_word(p, 4 * q), pt_word(p, 4 * q + 1),
                      pt_word(p, 4 * q + 2), pt_word(p, 4 * q + 3));
}

// The walk of slot j of window w, as described above.
__device__ __forceinline__ void msm_walk(uint4* rec, const int* digits,
                                         const int* px, const int* py,
                                         const int* pz, int* out, int w,
                                         int j, int n_points, int n_buckets,
                                         int signed_digits, int m_slots) {
  Pt acc;
  pt_set_identity(acc);
#pragma unroll 1
  for (int b = 0; b < n_buckets; ++b) bucket_store(rec, b, acc);

  // Each step's digit is read one step ahead, so the bucket's address is
  // known when the step starts; the bucket (device memory) is requested
  // before the point (L2).
  const int* drow = digits + (size_t)w * n_points;
  u32 next = j < n_points ? (u32)drow[j] : 0u;
#pragma unroll 1
  for (int n = j; n < n_points; n += m_slots) {
    const u32 d = next;
    next = n + m_slots < n_points ? (u32)drow[n + m_slots] : 0u;
    const u32 mag = signed_digits ? d & 0x3Fu : d;
    if (mag - 1u >= (u32)n_buckets) continue;  // 0 or above nb: discarded
    bucket_load(rec, (int)mag - 1, acc);
    Pt p;
    pt_load(px, py, pz, n_points, n, p);
    if (signed_digits && (d >> 6) == 1u) fe_neg<ModP>(p.y, p.y);
    pt_add(acc, p, acc);
    bucket_store(rec, (int)mag - 1, acc);
  }

#pragma unroll 1
  for (int b = 0; b < n_buckets; ++b) {
    bucket_load(rec, b, acc);
    int* slab = out + ((size_t)w * n_buckets + b) * 3 * 16 * m_slots;
    pt_store(slab, slab + 16 * m_slots, slab + 32 * m_slots, m_slots, j,
             acc);
  }
}
