// The GLV kernels: k1*P1 + k2*P2 per lane, the whole windowed
// double-and-add loop in one launch, in three forms that share one loop
// (glv_loop below), templated on the table's entry count, the digit
// encoding and the way the tables arrive.
//
// - glv_windowed_mult_signed (k_glv_signed) replaces the Pallas kernel
//   glv_windowed_mult_signed_from_points (secp256k1_tpu/ops/pallas/
//   kernels.py:1135, body _glv_mega_frompoints_kernel(signed_digits=True,
//   n_entries=8) :850): signed 4-bit digits, int32 [33, B], magnitude
//   (bits 0-3, in [0, 8]) | sign << 4; tables [P, .., 8P] built per lane.
// - glv_windowed_mult_unsigned (k_glv_unsigned) replaces
//   glv_windowed_mult_from_points (:1105, the same body with
//   signed_digits=False, n_entries=15): nibble digits, int32 [32, B] in
//   [0, 15]; tables [P, .., 15P] built per lane; no y negation.
// - glv_windowed_mult_tables (k_glv_tables) replaces glv_windowed_mult
//   (:1266, body _glv_mega_kernel :794): nibble digits and two prebuilt
//   per-lane tables int32 [15, 3, 16, B], each read once from global
//   memory into the thread's local table.
//
// Digits come most significant window first.  The from-points forms (the
// first two) make window 0 a select from table 1 (the whole identity
// (0, 1, 0) where the magnitude is 0, even with a sign bit set) and a
// lookup-add from table 2; each later window does 4 doublings and 2
// lookup-adds.  The prebuilt-table form starts from the identity and
// doubles 4 times in window 0 too, as _glv_mega_kernel does, so its
// projective X, Y, Z differ from the from-points forms' for the same
// scalar (the affine point is the same).  A lookup is a masked scan over
// every entry, never an index by the digit: ECDH feeds secret scalars to
// these kernels.  A set sign bit negates the selected y; magnitude 0
// passes the accumulator through.
//
// Bound: 32-bit integer multiply-adds.  Per lane (signed) 2 x 7 table
// points, 65 lookup-adds and 128 doublings: ~1,800 field multiplies of ~76
// wide products each; (unsigned) 2 x 14 table points, 64 lookup-adds and
// 124 doublings; (prebuilt tables) 64 lookup-adds and 124 doublings past
// the identity, after reading its two tables once (5,760 B a lane).
// Design: one thread per lane; the tables (2 x 8 x 96 B = 1.5 KB, or 2 x
// 15 x 96 B = 2.9 KB a lane) live in local memory (L1/L2), because
// registers cannot hold them and shared memory would cap a block at ~100
// lanes; the window and step loops are not unrolled, so one copy each of
// the add and the doubling is compiled.
#include <cuda_runtime.h>

#include "point.cuh"

template <bool SIGNED, class Tab>
__device__ __forceinline__ u32 select_entry(const Tab& tab, int d, Pt& sel) {
  const u32 mag = SIGNED ? ((u32)d & 0xFu) : (u32)d;
  fe_set_small(sel.x, 0);
  fe_set_small(sel.y, 0);
  fe_set_small(sel.z, 0);
  tab.scan(mag, sel);
  if (SIGNED) {
    u32 ny[8];
    fe_neg<ModP>(sel.y, ny);
    fe_cmov(sel.y, ny, 0u - (((u32)d >> 4) & 1u));
  }
  return mag;
}

template <bool SIGNED, class Tab>
__device__ __forceinline__ void lookup_add(Pt& acc, const Tab& tab, int d) {
  Pt sel;
  const u32 mag = select_entry<SIGNED>(tab, d, sel);
  Pt sum;
  pt_add(acc, sel, sum);
  pt_cmov(acc, sum, 0u - (u32)(mag != 0u));
}

// acc = sum over windows, as described above.  FROM_IDENTITY selects the
// prebuilt-table schedule (identity start, 4 doublings in every window).
template <bool SIGNED, bool FROM_IDENTITY, class Tab>
__device__ __forceinline__ void glv_loop(const int* d1, const int* d2,
                                         const Tab& t1, const Tab& t2,
                                         int lanes, int lane, int n_windows,
                                         Pt& acc) {
  int w0 = 0;
  if (FROM_IDENTITY) {
    pt_set_identity(acc);
  } else {
    // Window 0: a select from table 1, then a lookup-add from table 2.
    const u32 mag0 = select_entry<SIGNED>(t1, d1[lane], acc);
    u32 one[8];
    fe_set_small(one, 1);
    fe_cmov(acc.y, one, 0u - (u32)(mag0 == 0u));
    lookup_add<SIGNED>(acc, t2, d2[lane]);
    w0 = 1;
  }
#pragma unroll 1
  for (int w = w0; w < n_windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt_double(acc, acc);
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      const int* d = t == 0 ? d1 : d2;
      lookup_add<SIGNED>(acc, t == 0 ? t1 : t2, d[(size_t)w * lanes + lane]);
    }
  }
}

template <bool SIGNED, int E>
__device__ __forceinline__ void glv_from_points(
    const int* d1, const int* d2, const int* p1x, const int* p1y,
    const int* p1z, const int* p2x, const int* p2y, const int* p2z, int* ox,
    int* oy, int* oz, int lanes, int n_windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  LocalTable<E> t1, t2;
  Pt p;
  pt_load(p1x, p1y, p1z, lanes, lane, p);
  t1.build(p);
  pt_load(p2x, p2y, p2z, lanes, lane, p);
  t2.build(p);
  Pt acc;
  glv_loop<SIGNED, false>(d1, d2, t1, t2, lanes, lane, n_windows, acc);
  pt_store(ox, oy, oz, lanes, lane, acc);
}

__global__ void k_glv_signed(const int* d1, const int* d2, const int* p1x,
                             const int* p1y, const int* p1z, const int* p2x,
                             const int* p2y, const int* p2z, int* ox,
                             int* oy, int* oz, int lanes, int n_windows) {
  glv_from_points<true, 8>(d1, d2, p1x, p1y, p1z, p2x, p2y, p2z, ox, oy, oz,
                           lanes, n_windows);
}

__global__ void k_glv_unsigned(const int* d1, const int* d2, const int* p1x,
                               const int* p1y, const int* p1z,
                               const int* p2x, const int* p2y,
                               const int* p2z, int* ox, int* oy, int* oz,
                               int lanes, int n_windows) {
  glv_from_points<false, 15>(d1, d2, p1x, p1y, p1z, p2x, p2y, p2z, ox, oy,
                             oz, lanes, n_windows);
}

__global__ void k_glv_tables(const int* d1, const int* d2, const int* t1,
                             const int* t2, int* ox, int* oy, int* oz,
                             int lanes, int n_windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  LocalTable<15> tab1, tab2;
  tab1.load(t1, lanes, lane);
  tab2.load(t2, lanes, lane);
  Pt acc;
  glv_loop<false, true>(d1, d2, tab1, tab2, lanes, lane, n_windows, acc);
  pt_store(ox, oy, oz, lanes, lane, acc);
}

static const int kThreads = 128;

static dim3 grid_for(int lanes) {
  return dim3((unsigned)((lanes + kThreads - 1) / kThreads));
}

extern "C" int glv_windowed_mult_signed(
    const void* d1, const void* d2, const void* p1x, const void* p1y,
    const void* p1z, const void* p2x, const void* p2y, const void* p2z,
    void* ox, void* oy, void* oz, int lanes, int n_windows, void* stream) {
  k_glv_signed<<<grid_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)p1x, (const int*)p1y,
      (const int*)p1z, (const int*)p2x, (const int*)p2y, (const int*)p2z,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}

extern "C" int glv_windowed_mult_unsigned(
    const void* d1, const void* d2, const void* p1x, const void* p1y,
    const void* p1z, const void* p2x, const void* p2y, const void* p2z,
    void* ox, void* oy, void* oz, int lanes, int n_windows, void* stream) {
  k_glv_unsigned<<<grid_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)p1x, (const int*)p1y,
      (const int*)p1z, (const int*)p2x, (const int*)p2y, (const int*)p2z,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}

extern "C" int glv_windowed_mult_tables(const void* d1, const void* d2,
                                        const void* t1, const void* t2,
                                        void* ox, void* oy, void* oz,
                                        int lanes, int n_windows,
                                        void* stream) {
  k_glv_tables<<<grid_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)t1, (const int*)t2,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}
