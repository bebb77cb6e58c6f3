// point_add, point_double, point_double4 and point_add_mixed: lane-wise
// complete projective addition, doubling, four chained doublings and mixed
// addition on int32 [16, B] limb planes.
//
// Replaces the Pallas kernels point_add (secp256k1_tpu/ops/pallas/kernels.py
// :1376, padd :1308 -> _point_add_body :615), point_double (:1380, pdouble
// :1313 -> _point_double_body :653), point_double4 (:1384, pdouble4 :1317:
// four _point_double_body, one canonical store) and point_add_mixed
// (:1413, pmixed :1325 -> _point_add_mixed_body :676, RCB Algorithm 8 with
// Z2 = 1).  All are thin wrappers over pt_add, pt_double and pt_add_mixed
// of point.cuh, whose step order is the Pallas bodies', so the canonical
// X, Y, Z equal the JAX package's and the plain PyTorch formulas'
// (ops/point.py) bit for bit.
//
// Bound: bytes for point_add, point_double and point_add_mixed, products
// for point_double4.  Per lane point_add reads 6 planes and writes 3
// (9 x 64 B) and does 12 field products and 2 products by b3 (932
// 32 x 32 -> 64-bit products); on an H100 the 576 bytes take longer than
// the products.  point_double moves 6 planes for 2 squares, 6 products and
// one by b3; point_add_mixed 8 planes for 11 products and 2 by b3;
// point_double4 the same 6 planes for four times point_double's products
// (4 x 530 against 384 B, so the products bound it).  What holds
// point_double4 at about 4x its bound is the schedulers' issue (each wide
// product one IMAD.WIDE among ~220 instructions a field product; 16 warps
// an SM issue about 57 % of the peak): so it runs its four doublings on
// FieldLazy (point.cuh: reductions deferred, the result made canonical
// once at the store), 1,920 instructions a doubling in place of 2,048,
// 0.0354 -> 0.0334 ms at 65,536 lanes (H100 80GB HBM3, 700 W).  The same
// doublings with the products on the FP64 pipe (field_f64.cuh), on every
// warp or on half of each scheduler's, took 0.70x the time of field.cuh's
// (csrc/field_probe.cu).
// Design: one thread per lane, 128 threads a block, no shared memory; any
// B, the ragged edge masked by the lane bound (no padding to a tile).
// k_point_add is held to 128 registers (it took 140 unbounded, three
// blocks an SM), so four blocks of 128 fit an SM and 65,536 lanes run in
// one wave of 512 blocks over 528 slots.  The MSM's lane merge and
// weighted sums launch it at 960 to 491,520 lanes.  The other kernels here
// run on FieldCanon.
#include <cuda_runtime.h>

#include "point.cuh"

__global__ void __launch_bounds__(128, 4)
    k_point_add(const int* x1, const int* y1, const int* z1, const int* x2,
                const int* y2, const int* z2, int* ox, int* oy, int* oz,
                int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt p, q;
  pt_load(x1, y1, z1, lanes, lane, p);
  pt_load(x2, y2, z2, lanes, lane, q);
  pt_add(p, q, p);
  pt_store(ox, oy, oz, lanes, lane, p);
}

__global__ void k_point_double(const int* x, const int* y, const int* z,
                               int* ox, int* oy, int* oz, int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt p;
  pt_load(x, y, z, lanes, lane, p);
  pt_double(p, p);
  pt_store(ox, oy, oz, lanes, lane, p);
}

__global__ void k_point_dbl4(const int* x, const int* y, const int* z,
                             int* ox, int* oy, int* oz, int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt p;
  pt_load(x, y, z, lanes, lane, p);
#pragma unroll 1
  for (int i = 0; i < 4; ++i) pt_double<FieldLazy>(p, p);
  pt_canon<FieldLazy>(p);
  pt_store(ox, oy, oz, lanes, lane, p);
}

__global__ void k_point_mixed(const int* x1, const int* y1, const int* z1,
                              const int* x2, const int* y2, int* ox, int* oy,
                              int* oz, int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt p;
  u32 qx[8], qy[8];
  pt_load(x1, y1, z1, lanes, lane, p);
  load_fe(x2, lanes, lane, qx);
  load_fe(y2, lanes, lane, qy);
  pt_add_mixed(p, qx, qy, p);
  pt_store(ox, oy, oz, lanes, lane, p);
}

static const int kThreads = 128;

extern "C" int point_add(const void* x1, const void* y1, const void* z1,
                         const void* x2, const void* y2, const void* z2,
                         void* ox, void* oy, void* oz, int lanes,
                         void* stream) {
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_point_add<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, lanes);
  return (int)cudaGetLastError();
}

extern "C" int point_double(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, int lanes,
                            void* stream) {
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_point_double<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)y, (const int*)z, (int*)ox, (int*)oy,
      (int*)oz, lanes);
  return (int)cudaGetLastError();
}

extern "C" int point_double4(const void* x, const void* y, const void* z,
                             void* ox, void* oy, void* oz, int lanes,
                             void* stream) {
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_point_dbl4<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)y, (const int*)z, (int*)ox, (int*)oy,
      (int*)oz, lanes);
  return (int)cudaGetLastError();
}

extern "C" int point_add_mixed(const void* x1, const void* y1, const void* z1,
                               const void* x2, const void* y2, void* ox,
                               void* oy, void* oz, int lanes, void* stream) {
  dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads));
  k_point_mixed<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x1, (const int*)y1, (const int*)z1, (const int*)x2,
      (const int*)y2, (int*)ox, (int*)oy, (int*)oz, lanes);
  return (int)cudaGetLastError();
}

// Resident blocks of 128 threads an SM of k_point_add; -1 on an error.
extern "C" int point_add_blocks_per_sm(int) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k_point_add,
                                                    kThreads, 0))
    return -1;
  return blocks;
}
