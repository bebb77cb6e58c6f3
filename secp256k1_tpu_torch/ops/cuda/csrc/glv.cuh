// The GLV loops of the kernels in glv.cu, one lane at a time (see glv.cu
// for the designs).  A plain C++ compiler builds them too, so the CPU tests
// can run them against the plain versions.
#pragma once

#include "point.cuh"

// The loops run on the field operations F (point.cuh): #4 on FieldCanon,
// #7 and #9 on FieldLazy, their results made canonical at the store.

template <bool SIGNED, class F, class Tab>
__device__ __forceinline__ u32 select_entry(const Tab& tab, int d, Pt& sel) {
  const u32 mag = SIGNED ? ((u32)d & 0xFu) : (u32)d;
  fe_set_small(sel.x, 0);
  fe_set_small(sel.y, 0);
  fe_set_small(sel.z, 0);
  tab.scan(mag, sel);
  if (SIGNED) {
    u32 zero[8], ny[8];
    fe_set_small(zero, 0);
    F::sub(zero, sel.y, ny);
    fe_cmov(sel.y, ny, 0u - (((u32)d >> 4) & 1u));
  }
  return mag;
}

template <bool SIGNED, class F, class Tab>
__device__ __forceinline__ void lookup_add(Pt& acc, const Tab& tab, int d) {
  Pt sel;
  const u32 mag = select_entry<SIGNED, F>(tab, d, sel);
  Pt sum;
  pt_add<F>(acc, sel, sum);
  pt_cmov(acc, sum, 0u - (u32)(mag != 0u));
}

// acc = sum over windows, as glv.cu describes.  FROM_IDENTITY selects the
// prebuilt-table schedule (identity start, 4 doublings in every window).
template <bool SIGNED, bool FROM_IDENTITY, class F, class Tab>
__device__ __forceinline__ void glv_loop(const int* d1, const int* d2,
                                         const Tab& t1, const Tab& t2,
                                         int lanes, int lane, int n_windows,
                                         Pt& acc) {
  int w0 = 0;
  if (FROM_IDENTITY) {
    pt_set_identity(acc);
  } else {
    // Window 0: a select from table 1, then a lookup-add from table 2.
    const u32 mag0 = select_entry<SIGNED, F>(t1, d1[lane], acc);
    u32 one[8];
    fe_set_small(one, 1);
    fe_cmov(acc.y, one, 0u - (u32)(mag0 == 0u));
    lookup_add<SIGNED, F>(acc, t2, d2[lane]);
    w0 = 1;
  }
#pragma unroll 1
  for (int w = w0; w < n_windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt_double<F>(acc, acc);
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      const int* d = t == 0 ? d1 : d2;
      lookup_add<SIGNED, F>(acc, t == 0 ? t1 : t2,
                            d[(size_t)w * lanes + lane]);
    }
  }
}

template <bool SIGNED, int E, class F = FieldCanon>
__device__ __forceinline__ void glv_from_points(
    const int* d1, const int* d2, const int* p1x, const int* p1y,
    const int* p1z, const int* p2x, const int* p2y, const int* p2z, int* ox,
    int* oy, int* oz, int lanes, int n_windows, int lane) {
  LocalTable<E> t1, t2;
  Pt p;
  pt_load(p1x, p1y, p1z, lanes, lane, p);
  t1.template build<F>(p);
  pt_load(p2x, p2y, p2z, lanes, lane, p);
  t2.template build<F>(p);
  Pt acc;
  glv_loop<SIGNED, false, F>(d1, d2, t1, t2, lanes, lane, n_windows, acc);
  pt_canon<F>(acc);
  pt_store(ox, oy, oz, lanes, lane, acc);
}

// The prebuilt-table form: each lane table read once into a local table.
// The tables arrive canonical, and FieldLazy takes any input below 2^256.
template <class F = FieldLazy>
__device__ __forceinline__ void glv_from_tables(const int* d1, const int* d2,
                                                const int* t1, const int* t2,
                                                int* ox, int* oy, int* oz,
                                                int lanes, int n_windows,
                                                int lane) {
  LocalTable<15> tab1, tab2;
  tab1.load(t1, lanes, lane);
  tab2.load(t2, lanes, lane);
  Pt acc;
  glv_loop<false, true, F>(d1, d2, tab1, tab2, lanes, lane, n_windows, acc);
  pt_canon<F>(acc);
  pt_store(ox, oy, oz, lanes, lane, acc);
}
