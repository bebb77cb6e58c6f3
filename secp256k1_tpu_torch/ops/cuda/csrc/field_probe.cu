// Measurement kernels of the two field cores (no path launches them):
// chip_smoke.py times them to decide which pipe the products belong on.
//
// - k_field_probe: each lane runs `iters` rounds of 4 independent chains
//   x_c = x_c * y mod p, on field.cuh (int), on field_f64.cuh (f64), with
//   warps split between the two (a warp's core set by its index: of each 4
//   consecutive warps, one per scheduler, the first `f64_groups` groups
//   take the FP64 core), or with both cores in one thread (2 chains each).
// - k_dbl4_probe: k_point_dbl4's four doublings at 256 threads a block
//   (two blocks an SM, one wave at 65,536 lanes) under FieldCanon,
//   FieldLazy, FieldF64, or warps 0-3 of a block on FieldCanon and 4-7 on
//   FieldF64 (each scheduler holds warps of both kinds).
// Every mode gives the same words, so the probes also hold the cores to
// each other on the card.
#include <cuda_runtime.h>

#include "field_f64.cuh"
#include "point.cuh"

constexpr int CHAINS = 4;
constexpr int PROBE_THREADS = 512;
constexpr int DBL4_THREADS = 256;

template <int F64>
__device__ __forceinline__ void probe_mul(const u32 a[8], const u32 b[8],
                                          u32 o[8]) {
  if (F64)
    f64::fe_mul(a, b, o);
  else
    fe_mul<ModP>(a, b, o);
}

// kind: 0 int, 1 f64, 2 both (half the chains each).
template <int KIND>
__device__ __forceinline__ void probe_chains(u32 x[CHAINS][8],
                                             const u32 y[8], int iters) {
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 1 || (KIND == 2 && c >= CHAINS / 2))
        probe_mul<1>(x[c], y, x[c]);
      else
        probe_mul<0>(x[c], y, x[c]);
    }
  }
}

// mode: 0 int, 1 f64, 2..4 (mode - 1) of the 4 warp groups of a block on
// f64, 5 both cores in each thread.
template <int MODE>
__global__ void __launch_bounds__(PROBE_THREADS, 1)
    k_field_probe(const int* a, const int* b, int* out, int lanes,
                  int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  u32 x[CHAINS][8], y[8];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    load_fe(a + c * 16 * lanes, lanes, lane, x[c]);
  load_fe(b, lanes, lane, y);
  const int group = (threadIdx.x >> 5) >> 2;  // warp-uniform
  if (MODE == 1 || (MODE >= 2 && MODE <= 4 && group < MODE - 1))
    probe_chains<1>(x, y, iters);
  else if (MODE == 5)
    probe_chains<2>(x, y, iters);
  else
    probe_chains<0>(x, y, iters);
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    store_fe(out + c * 16 * lanes, lanes, lane, x[c]);
}

template <class F>
__device__ __forceinline__ void dbl4(Pt& p) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) pt_double<F>(p, p);
  pt_canon<F>(p);
}

template <int MODE>
__global__ void __launch_bounds__(DBL4_THREADS, 2)
    k_dbl4_probe(const int* x, const int* y, const int* z, int* ox, int* oy,
                 int* oz, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  Pt p;
  pt_load(x, y, z, lanes, lane, p);
  if (MODE == 0 || (MODE == 3 && threadIdx.x < 128))
    dbl4<FieldCanon>(p);
  else if (MODE == 1)
    dbl4<FieldLazy>(p);
  else
    dbl4<FieldF64>(p);
  pt_store(ox, oy, oz, lanes, lane, p);
}

template <int MODE>
static void launch_field(dim3 grid, cudaStream_t s, const int* a,
                         const int* b, int* out, int lanes, int iters) {
  k_field_probe<MODE><<<grid, PROBE_THREADS, 0, s>>>(a, b, out, lanes, iters);
}

template <int MODE>
static void launch_dbl4(dim3 grid, cudaStream_t s, const int* x,
                        const int* y, const int* z, int* ox, int* oy,
                        int* oz, int lanes) {
  k_dbl4_probe<MODE><<<grid, DBL4_THREADS, 0, s>>>(x, y, z, ox, oy, oz,
                                                   lanes);
}

// a: int32 [16 * CHAINS, lanes] (x of each chain), b: [16, lanes] (y),
// out like a.
extern "C" int field_probe(const void* a, const void* b, void* out, int mode,
                           int lanes, int iters, void* stream) {
  const dim3 grid((unsigned)((lanes + PROBE_THREADS - 1) / PROBE_THREADS));
  void (*launch[6])(dim3, cudaStream_t, const int*, const int*, int*, int,
                    int) = {launch_field<0>, launch_field<1>,
                            launch_field<2>, launch_field<3>,
                            launch_field<4>, launch_field<5>};
  if (mode < 0 || mode > 5) return -1;
  launch[mode](grid, (cudaStream_t)stream, (const int*)a, (const int*)b,
               (int*)out, lanes, iters);
  return (int)cudaGetLastError();
}

// mode: 0 FieldCanon, 1 FieldLazy, 2 FieldF64, 3 warps 0-3 FieldCanon and
// 4-7 FieldF64.
extern "C" int dbl4_probe(const void* x, const void* y, const void* z,
                          void* ox, void* oy, void* oz, int mode, int lanes,
                          void* stream) {
  const dim3 grid((unsigned)((lanes + DBL4_THREADS - 1) / DBL4_THREADS));
  void (*launch[4])(dim3, cudaStream_t, const int*, const int*, const int*,
                    int*, int*, int*, int) = {
      launch_dbl4<0>, launch_dbl4<1>, launch_dbl4<2>, launch_dbl4<3>};
  if (mode < 0 || mode > 3) return -1;
  launch[mode](grid, (cudaStream_t)stream, (const int*)x, (const int*)y,
               (const int*)z, (int*)ox, (int*)oy, (int*)oz, lanes);
  return (int)cudaGetLastError();
}
