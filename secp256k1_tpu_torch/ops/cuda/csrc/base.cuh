// The per-lane window step of the fixed-base kernels (base.cu) and, under
// nvcc only, the device primitives their table reads are built from: the
// int8 tensor-core product and the asynchronous copy to shared memory.  A
// plain C++ compiler builds the step, so the CPU tests can run it against
// the plain versions.
#pragma once

#include "point.cuh"

// Window w of one lane: (x, y) the selected entry's words (anything where
// mag is 0), y negated here for a set sign bit (neg, 0 or 1).  Window 0 is
// a select: (x, +-y, 1), or the identity (0, 1, 0) where mag is 0, even
// with the sign bit set.  Each later window is a mixed add of (x, +-y),
// computed on every window and passed through where mag is 0.  The same
// steps in the same order as `_base_accumulate_plain` (ops/cuda/kernels.py),
// so X, Y, Z are its canonical values.
__device__ __forceinline__ void base_step(Pt& acc, int w, u32 mag, u32 neg,
                                          const u32 x[8], u32 y[8]) {
  u32 ny[8];
  fe_neg<ModP>(y, ny);
  fe_cmov(y, ny, 0u - neg);
  const u32 nonzero = 0u - (u32)(mag != 0u);
  if (w == 0) {
    Pt first;
    fe_copy(first.x, x);
    fe_copy(first.y, y);
    fe_set_small(first.z, 1);
    pt_set_identity(acc);
    pt_cmov(acc, first, nonzero);
  } else {
    Pt sum;
    pt_add_mixed(acc, x, y, sum);
    pt_cmov(acc, sum, nonzero);
  }
}

// The end of base_windowed_add_final: acc + Q, a complete add.
__device__ __forceinline__ void base_final_add(Pt& acc, const Pt& q) {
  pt_add(acc, q, acc);
}

// Magnitude and sign bit of a digit: signed digits are magnitude (bits
// 0-15) | sign << 16, unsigned ones the magnitude alone.
__device__ __forceinline__ u32 digit_mag(u32 d, int signed_digits) {
  return signed_digits ? d & 0xFFFFu : d;
}

__device__ __forceinline__ u32 digit_neg(u32 d, int signed_digits) {
  return signed_digits ? (d >> 16) & 1u : 0u;
}

// The entry a public digit gathers from the [W, E, 16] word table: mag - 1,
// entry 0 where mag is 0 (the step masks it).  Digits come from
// table._signed_digits (mag <= E); the clamp only keeps a malformed digit
// plane inside the table.
__device__ __forceinline__ int gather_entry(u32 mag, int n_entries) {
  const u32 e = mag < (u32)n_entries ? mag : (u32)n_entries;
  return mag == 0u ? 0 : (int)e - 1;
}

#ifdef __CUDACC__

// d += a * b, one warp: a 16 x 32 u8 (row), b 32 x 8 u8 (col), d 16 x 8
// s32, in the mma.sync fragment layouts (PTX ISA, "Matrix Fragments for
// mma.m16n8k32").  With g = lane / 4 and t = lane % 4: a[0] holds row g,
// columns 4t..4t+3 (byte i column 4t+i); a[1] row g+8, the same columns;
// a[2] row g, columns 16+4t..; a[3] row g+8, columns 16+4t..; b[0] rows
// 4t..4t+3 of column g, b[1] rows 16+4t.. of column g; d[0], d[1] row g,
// columns 2t, 2t+1; d[2], d[3] row g+8, the same columns.
__device__ __forceinline__ void mma_u8(int d[4], const u32 a[4],
                                       const u32 b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, one warp:
// lanes 8i .. 8i + 7 give the 16-byte row addresses of matrix i, and lane
// 4r + c receives elements 2c, 2c + 1 of row r of each matrix, in r[i].
__device__ __forceinline__ void ldsm_x4(u32 r[4], const void* smem_row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// v << s, 0 for s >= 32 (PTX clamps the shift amount).
__device__ __forceinline__ u32 shl_clamp(u32 v, u32 s) {
  u32 r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(s));
  return r;
}

// 16 bytes from global to shared memory without passing through registers
// (L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight;
// the landed copies are then visible to this thread.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

#endif
