// The bucket walk of k_msm_buckets (msm.cu): one slot of one window, its
// buckets addressed by the digit, in device memory; and the window fold of
// k_msm_fold, a warp's lanes sharing each point formula.  See msm.cu for
// the designs.  A plain C++ compiler builds both (uint4 below; the fold's
// rounds run step by step), so the CPU tests can run them against the
// plain versions.
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

// The Horner fold of combine_windows (ops/msm.py; k_msm_fold, msm.cu):
// acc = sum over windows i of 2^(window_bits * i) W_i, from the identity,
// most significant window first, each window window_bits complete
// doublings (RCB Algorithm 9) and then one complete add of its sum
// (Algorithm 7, acc the first operand).  rows: int32 [W, 3, 16] window
// sums of 16-bit limbs.
//
// The fold is serial, and one thread's chain of field products is its
// latency.  But each formula's products fall into rounds of independent
// ones (4 and 4 in a doubling, 6 and 6 in an add), so a warp's lanes
// share a formula: lane t does step t of each round on a register file in
// shared memory, and the lanes meet after each round.  A round's steps
// write registers that no step of the same round reads, so the order of a
// round's steps is free (the host below runs them one by one); every step
// is a canonical field operation, so the X, Y, Z are those of
// pt_double and pt_add (point.cuh), the launches this fold replaced.
#ifndef __CUDACC__
#define __constant__
#endif

enum FoldReg : unsigned char {
  FX, FY, FZ,         // the accumulator
  FQX, FQY, FQZ,      // the window's sum
  FA0,                // FA0 .. FA0 + 17: temporaries
  FOLD_REGS = FA0 + 18
};
enum FoldOp : unsigned char { F_NONE, F_MUL, F_ADD, F_SUB, F_MUL21 };
struct FoldStep {
  unsigned char op, dst, a, b;
};
constexpr int FOLD_ROUNDS = 7;
constexpr int FOLD_WIDTH = 6;
#define FA(i) (FA0 + (i))
#define FOLD_SKIP {F_NONE, 0, 0, 0}

// 2 (X, Y, Z), the steps of pt_double: t0 = Y^2 (A0), t1 = YZ (A1),
// Z^2 (A2), XY (A3); 2 t0 (A4), t2 = 21 Z^2 (A5); 4 t0 (A6), y3 = t0 + t2
// (A7), 2 t2 (A8); z3 = 8 t0 (A9), 3 t2 (A10); t0' = t0 - 3 t2 (A11);
// x3 = t2 z3 (A4), Z = t1 z3, t0' y3 (A6), t0' XY (A8); Y = x3 + t0' y3,
// X = 2 t0' XY.
__constant__ FoldStep kFoldDouble[FOLD_ROUNDS][FOLD_WIDTH] = {
    {{F_MUL, FA(0), FY, FY}, {F_MUL, FA(1), FY, FZ}, {F_MUL, FA(2), FZ, FZ},
     {F_MUL, FA(3), FX, FY}, FOLD_SKIP, FOLD_SKIP},
    {{F_ADD, FA(4), FA(0), FA(0)}, {F_MUL21, FA(5), FA(2), FA(2)}, FOLD_SKIP,
     FOLD_SKIP, FOLD_SKIP, FOLD_SKIP},
    {{F_ADD, FA(6), FA(4), FA(4)}, {F_ADD, FA(7), FA(0), FA(5)},
     {F_ADD, FA(8), FA(5), FA(5)}, FOLD_SKIP, FOLD_SKIP, FOLD_SKIP},
    {{F_ADD, FA(9), FA(6), FA(6)}, {F_ADD, FA(10), FA(8), FA(5)}, FOLD_SKIP,
     FOLD_SKIP, FOLD_SKIP, FOLD_SKIP},
    {{F_SUB, FA(11), FA(0), FA(10)}, FOLD_SKIP, FOLD_SKIP, FOLD_SKIP,
     FOLD_SKIP, FOLD_SKIP},
    {{F_MUL, FA(4), FA(5), FA(9)}, {F_MUL, FZ, FA(1), FA(9)},
     {F_MUL, FA(6), FA(11), FA(7)}, {F_MUL, FA(8), FA(11), FA(3)},
     FOLD_SKIP, FOLD_SKIP},
    {{F_ADD, FY, FA(4), FA(6)}, {F_ADD, FX, FA(8), FA(8)}, FOLD_SKIP,
     FOLD_SKIP, FOLD_SKIP, FOLD_SKIP},
};

// (X, Y, Z) + (QX, QY, QZ), the steps of pt_add: the sums X + Y, QX + QY,
// Y + Z, QY + QZ, X + Z, QX + QZ (A0-A5); t0 = X QX (A6), t1 = Y QY (A7),
// t2 = Z QZ (A8) and the three products of sums (A9-A11); t0 + t1,
// t1 + t2, t0 + t2, 2 t0, 21 t2 (A0-A4); t3 (A5), t4 (A12), y3 (A13),
// 3 t0 (A14), z3 = t1 + 21 t2 (A15), t1' = t1 - 21 t2 (A16); 21 y3 (A17);
// t4 21y3 (A0), t3 t1' (A1), 21y3 3t0 (A2), t1' z3 (A3), 3t0 t3 (A4),
// z3 t4 (A6); X = A1 - A0, Y = A3 + A2, Z = A6 + A4.
__constant__ FoldStep kFoldAdd[FOLD_ROUNDS][FOLD_WIDTH] = {
    {{F_ADD, FA(0), FX, FY}, {F_ADD, FA(1), FQX, FQY},
     {F_ADD, FA(2), FY, FZ}, {F_ADD, FA(3), FQY, FQZ},
     {F_ADD, FA(4), FX, FZ}, {F_ADD, FA(5), FQX, FQZ}},
    {{F_MUL, FA(6), FX, FQX}, {F_MUL, FA(7), FY, FQY},
     {F_MUL, FA(8), FZ, FQZ}, {F_MUL, FA(9), FA(0), FA(1)},
     {F_MUL, FA(10), FA(2), FA(3)}, {F_MUL, FA(11), FA(4), FA(5)}},
    {{F_ADD, FA(0), FA(6), FA(7)}, {F_ADD, FA(1), FA(7), FA(8)},
     {F_ADD, FA(2), FA(6), FA(8)}, {F_ADD, FA(3), FA(6), FA(6)},
     {F_MUL21, FA(4), FA(8), FA(8)}, FOLD_SKIP},
    {{F_SUB, FA(5), FA(9), FA(0)}, {F_SUB, FA(12), FA(10), FA(1)},
     {F_SUB, FA(13), FA(11), FA(2)}, {F_ADD, FA(14), FA(3), FA(6)},
     {F_ADD, FA(15), FA(7), FA(4)}, {F_SUB, FA(16), FA(7), FA(4)}},
    {{F_MUL21, FA(17), FA(13), FA(13)}, FOLD_SKIP, FOLD_SKIP, FOLD_SKIP,
     FOLD_SKIP, FOLD_SKIP},
    {{F_MUL, FA(0), FA(12), FA(17)}, {F_MUL, FA(1), FA(5), FA(16)},
     {F_MUL, FA(2), FA(17), FA(14)}, {F_MUL, FA(3), FA(16), FA(15)},
     {F_MUL, FA(4), FA(14), FA(5)}, {F_MUL, FA(6), FA(15), FA(12)}},
    {{F_SUB, FX, FA(1), FA(0)}, {F_ADD, FY, FA(3), FA(2)},
     {F_ADD, FZ, FA(6), FA(4)}, FOLD_SKIP, FOLD_SKIP, FOLD_SKIP},
};
#undef FA
#undef FOLD_SKIP

// One step on the register file: a canonical field operation.  A product
// of equal registers is a product too (the same residue as a square), so
// the lanes of a round of products take one path.
__device__ __forceinline__ void fold_step(u32 (*reg)[8], FoldStep s) {
  if (s.op == F_NONE) return;
  u32 a[8], b[8], r[8];
  fe_copy(a, reg[s.a]);
  fe_copy(b, reg[s.b]);
  if (s.op == F_MUL) {
    fe_mul<ModP>(a, b, r);
  } else if (s.op == F_ADD) {
    fe_add<ModP>(a, b, r);
  } else if (s.op == F_SUB) {
    fe_sub<ModP>(a, b, r);
  } else {
    fe_mulw<ModP>(a, 21u, r);
  }
  fe_copy(reg[s.dst], r);
}

// Whether no step of a round writes a register that another step of the
// round reads or writes (so the steps of a round may run in any order).
inline bool fold_program_ok(const FoldStep (*prog)[FOLD_WIDTH]) {
  for (int r = 0; r < FOLD_ROUNDS; ++r)
    for (int i = 0; i < FOLD_WIDTH; ++i) {
      const FoldStep s = prog[r][i];
      if (s.op == F_NONE) continue;
      for (int j = 0; j < FOLD_WIDTH; ++j) {
        const FoldStep o = prog[r][j];
        if (o.op == F_NONE) continue;
        if ((j != i && o.dst == s.dst) || o.a == s.dst || o.b == s.dst)
          return false;
      }
    }
  return true;
}

#ifndef __CUDACC__
// The fold with the steps of each round run one after another.
inline void fold_windows(const int* rows, int n_windows, int window_bits,
                         Pt& acc) {
  u32 reg[FOLD_REGS][8] = {};
  reg[FY][0] = 1;  // the identity (0, 1, 0)
  for (int i = n_windows - 1; i >= 0; --i) {
    const int* row = rows + (size_t)i * 48;
    for (int d = 0; d < window_bits; ++d)
      for (int r = 0; r < FOLD_ROUNDS; ++r)
        for (int t = 0; t < FOLD_WIDTH; ++t) fold_step(reg, kFoldDouble[r][t]);
    for (int c = 0; c < 3; ++c) load_fe(row + 16 * c, 1, 0, reg[FQX + c]);
    for (int r = 0; r < FOLD_ROUNDS; ++r)
      for (int t = 0; t < FOLD_WIDTH; ++t) fold_step(reg, kFoldAdd[r][t]);
  }
  fe_copy(acc.x, reg[FX]);
  fe_copy(acc.y, reg[FY]);
  fe_copy(acc.z, reg[FZ]);
}
#endif
