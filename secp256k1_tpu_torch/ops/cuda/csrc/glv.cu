// The GLV kernels: k1*P1 + k2*P2 per lane, the whole windowed
// double-and-add loop in one launch, in three forms that share one loop
// (glv_loop, glv.cuh), templated on the table's entry count, the digit
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
// wide products each (0.55 ms at 65,536 lanes on an H100: 132 SMs x 64 a
// clock x 1.98 GHz); (unsigned) 2 x 14 table points, 64 lookup-adds and
// 124 doublings; (prebuilt tables) 64 lookup-adds and 124 doublings past
// the identity, after reading its two tables once (5,760 B a lane).  What
// holds them near 4-5x that bound is the schedulers' issue, not a pipe:
// each wide product is one IMAD.WIDE, and a field product costs about 220
// instructions in all (the IMAD.WIDE, the carry chains, the reduction's
// selects); at one wave of 16 warps an SM the field core alone issues
// about 57 % of the schedulers' peak, waiting on the chains.  So fewer
// instructions, not another pipe, is the lever: a second field core with
// its products on the FP64 pipe (bit-exact) needs about 380 instructions a
// product and loses, alone (0.59x) and with warps split between the cores
// (at best 0.90x; the FP64 finding in PERF.md section 6).
//
// Design: one thread per lane, 128 threads a block, at most 128 registers a
// thread (__launch_bounds__ with four blocks an SM), so the 65,536 lanes of
// a verify or ECDH batch run in one wave (132 SMs x 512 threads) instead of
// 1.3 waves whose second one leaves most SMs idle.  The field core
// (field.cuh) writes each product row, sum and difference as PTX carry
// chains.  The tables (2 x 8 x 96 B = 1.5 KB, or 2 x 15 x 96 B = 2.9 KB a
// lane) live in local memory (L1/L2), because registers cannot hold them
// and shared memory would cap a block at ~100 lanes; the window and step
// loops are not unrolled, so one copy each of the add and the doubling is
// compiled.  k_glv_signed (#4) runs on FieldCanon (every sum and product
// reduced to < p at once).  k_glv_unsigned (#7) and k_glv_tables (#9) run
// on FieldLazy (point.cuh: products, sums and differences left below
// 2^256 and made canonical at the store, about 10 % fewer instructions):
// #7 3.03 -> 2.78 ms at 65,536 lanes on an H100 80GB HBM3 at 700 W, the
// same X, Y, Z; #9 takes its canonical tables from global memory as they
// are.  Two changes to its table scans were tried and dropped (no
// gain): entries read as 16-byte local loads, and both tables scanned in
// one pass (both selects live at once, more spills).
// Cooperative lanes (4-8 threads a lane, products by warp shuffles) were
// not tried.  The per-lane loop is in glv.cuh.
#include <cuda_runtime.h>

#include "glv.cuh"

constexpr int GLV_THREADS = 128;
constexpr int GLV_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
    k_glv_signed(const int* d1, const int* d2, const int* p1x,
                 const int* p1y, const int* p1z, const int* p2x,
                 const int* p2y, const int* p2z, int* ox, int* oy, int* oz,
                 int lanes, int n_windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  glv_from_points<true, 8>(d1, d2, p1x, p1y, p1z, p2x, p2y, p2z, ox, oy, oz,
                           lanes, n_windows, lane);
}

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
    k_glv_unsigned(const int* d1, const int* d2, const int* p1x,
                   const int* p1y, const int* p1z, const int* p2x,
                   const int* p2y, const int* p2z, int* ox, int* oy,
                   int* oz, int lanes, int n_windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  glv_from_points<false, 15, FieldLazy>(d1, d2, p1x, p1y, p1z, p2x, p2y,
                                        p2z, ox, oy, oz, lanes, n_windows,
                                        lane);
}

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
    k_glv_tables(const int* d1, const int* d2, const int* t1, const int* t2,
                 int* ox, int* oy, int* oz, int lanes, int n_windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  glv_from_tables(d1, d2, t1, t2, ox, oy, oz, lanes, n_windows, lane);
}

static dim3 grid_for(int lanes) {
  return dim3((unsigned)((lanes + GLV_THREADS - 1) / GLV_THREADS));
}

extern "C" int glv_windowed_mult_signed(
    const void* d1, const void* d2, const void* p1x, const void* p1y,
    const void* p1z, const void* p2x, const void* p2y, const void* p2z,
    void* ox, void* oy, void* oz, int lanes, int n_windows, void* stream) {
  k_glv_signed<<<grid_for(lanes), GLV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)p1x, (const int*)p1y,
      (const int*)p1z, (const int*)p2x, (const int*)p2y, (const int*)p2z,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}

extern "C" int glv_windowed_mult_unsigned(
    const void* d1, const void* d2, const void* p1x, const void* p1y,
    const void* p1z, const void* p2x, const void* p2y, const void* p2z,
    void* ox, void* oy, void* oz, int lanes, int n_windows, void* stream) {
  k_glv_unsigned<<<grid_for(lanes), GLV_THREADS, 0, (cudaStream_t)stream>>>(
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
  k_glv_tables<<<grid_for(lanes), GLV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)d1, (const int*)d2, (const int*)t1, (const int*)t2,
      (int*)ox, (int*)oy, (int*)oz, lanes, n_windows);
  return (int)cudaGetLastError();
}
