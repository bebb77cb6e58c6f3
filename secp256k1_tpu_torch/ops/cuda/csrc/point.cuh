// Point formulas of the verify-path kernels: the complete projective
// formulas of Renes-Costello-Batina 2015 (a = 0, b3 = 21) over the field core
// of field.cuh, one lane per thread.
//
// Replaces the Pallas point bodies (secp256k1_tpu/ops/pallas/kernels.py:
// _point_add_body :615, _point_double_body :653, _point_add_mixed_body :676)
// inside the GLV and fixed-base kernels.  The step order is theirs, step for
// step, so that every canonical X, Y, Z equals the JAX package's and the
// plain PyTorch version's (ops/point.py), not only the affine point.  Every
// field op here is canonical; the Pallas bodies' lazy reduction changes only
// non-canonical intermediates.
//
// The formulas take their field operations from a policy, FieldCanon or
// FieldLazy below; each gives the same steps and canonical X, Y, Z.
//
// Also the per-lane point tables of the GLV kernels and of point_lookup_add:
// LocalTable (built in a thread's local memory) and LaneTable (read from
// global memory), each selecting an entry by a masked scan of all entries.
#pragma once

#include "field.cuh"

struct Pt {
  u32 x[8], y[8], z[8];
};

// The field operations under the point formulas (mod p).  FieldCanon:
// field.cuh, every result canonical.  FieldLazy: field.cuh with the
// reductions deferred (results below 2^256, canonical only after `canon`,
// which a kernel applies at its store); fewer instructions for the same
// products.  Either gives the same canonical X, Y, Z at the store.
struct FieldCanon {
  __device__ static __forceinline__ void mul(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_mul<ModP>(a, b, o);
  }
  __device__ static __forceinline__ void sqr(const u32 a[8], u32 o[8]) {
    fe_sqr<ModP>(a, o);
  }
  __device__ static __forceinline__ void mulw(const u32 a[8], u32 w,
                                              u32 o[8]) {
    fe_mulw<ModP>(a, w, o);
  }
  __device__ static __forceinline__ void add(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_add<ModP>(a, b, o);
  }
  __device__ static __forceinline__ void sub(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_sub<ModP>(a, b, o);
  }
  __device__ static __forceinline__ void canon(const u32 a[8], u32 o[8]) {
    fe_copy(o, a);
  }
};

struct FieldLazy {
  __device__ static __forceinline__ void mul(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_mul_lazy(a, b, o);
  }
  __device__ static __forceinline__ void sqr(const u32 a[8], u32 o[8]) {
    fe_sqr_lazy(a, o);
  }
  __device__ static __forceinline__ void mulw(const u32 a[8], u32 w,
                                              u32 o[8]) {
    mulw_folded<ModP>(a, w, o);
  }
  __device__ static __forceinline__ void add(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_add_lazy(a, b, o);
  }
  __device__ static __forceinline__ void sub(const u32 a[8], const u32 b[8],
                                             u32 o[8]) {
    fe_sub_lazy(a, b, o);
  }
  __device__ static __forceinline__ void canon(const u32 a[8], u32 o[8]) {
    cond_sub<ModP>(a, o);
  }
};

__device__ __forceinline__ void pt_copy(Pt& d, const Pt& s) {
  fe_copy(d.x, s.x);
  fe_copy(d.y, s.y);
  fe_copy(d.z, s.z);
}

// d = mask ? s : d (branch-free).
__device__ __forceinline__ void pt_cmov(Pt& d, const Pt& s, u32 mask) {
  fe_cmov(d.x, s.x, mask);
  fe_cmov(d.y, s.y, mask);
  fe_cmov(d.z, s.z, mask);
}

__device__ __forceinline__ void pt_load(const int* x, const int* y,
                                        const int* z, int lanes, int lane,
                                        Pt& p) {
  load_fe(x, lanes, lane, p.x);
  load_fe(y, lanes, lane, p.y);
  load_fe(z, lanes, lane, p.z);
}

__device__ __forceinline__ void pt_store(int* x, int* y, int* z, int lanes,
                                         int lane, const Pt& p) {
  store_fe(x, lanes, lane, p.x);
  store_fe(y, lanes, lane, p.y);
  store_fe(z, lanes, lane, p.z);
}

// p made canonical in place (a no-op under FieldCanon).
template <class F>
__device__ __forceinline__ void pt_canon(Pt& p) {
  F::canon(p.x, p.x);
  F::canon(p.y, p.y);
  F::canon(p.z, p.z);
}

// r = p + q, RCB Algorithm 7.  r may alias p or q.
template <class F = FieldCanon>
__device__ __forceinline__ void pt_add(const Pt& p, const Pt& q, Pt& r) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], x3[8], y3[8], z3[8];
  F::mul(p.x, q.x, t0);
  F::mul(p.y, q.y, t1);
  F::mul(p.z, q.z, t2);
  F::add(p.x, p.y, t3);
  F::add(q.x, q.y, t4);
  F::mul(t3, t4, t3);
  F::add(t0, t1, t4);
  F::sub(t3, t4, t3);
  F::add(p.y, p.z, t4);
  F::add(q.y, q.z, x3);
  F::mul(t4, x3, t4);
  F::add(t1, t2, x3);
  F::sub(t4, x3, t4);
  F::add(p.x, p.z, x3);
  F::add(q.x, q.z, y3);
  F::mul(x3, y3, x3);
  F::add(t0, t2, y3);
  F::sub(x3, y3, y3);
  F::add(t0, t0, x3);
  F::add(x3, t0, t0);
  F::mulw(t2, 21u, t2);
  F::add(t1, t2, z3);
  F::sub(t1, t2, t1);
  F::mulw(y3, 21u, y3);
  F::mul(t4, y3, x3);
  F::mul(t3, t1, t2);
  F::sub(t2, x3, x3);
  F::mul(y3, t0, y3);
  F::mul(t1, z3, t1);
  F::add(t1, y3, y3);
  F::mul(t0, t3, t0);
  F::mul(z3, t4, z3);
  F::add(z3, t0, z3);
  fe_copy(r.x, x3);
  fe_copy(r.y, y3);
  fe_copy(r.z, z3);
}

// r = p + (qx, qy, 1), RCB Algorithm 8.  The affine point cannot be the
// identity; callers mask digit 0.  r may alias p.
__device__ __forceinline__ void pt_add_mixed(const Pt& p, const u32 qx[8],
                                             const u32 qy[8], Pt& r) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], x3[8], y3[8], z3[8];
  fe_mul<ModP>(p.x, qx, t0);
  fe_mul<ModP>(p.y, qy, t1);
  fe_add<ModP>(qx, qy, t3);
  fe_add<ModP>(p.x, p.y, t4);
  fe_mul<ModP>(t3, t4, t3);
  fe_add<ModP>(t0, t1, t4);
  fe_sub<ModP>(t3, t4, t3);
  fe_mul<ModP>(qy, p.z, t4);
  fe_add<ModP>(t4, p.y, t4);
  fe_mul<ModP>(qx, p.z, y3);
  fe_add<ModP>(y3, p.x, y3);
  fe_add<ModP>(t0, t0, x3);
  fe_add<ModP>(x3, t0, t0);
  fe_mulw<ModP>(p.z, 21u, t2);
  fe_add<ModP>(t1, t2, z3);
  fe_sub<ModP>(t1, t2, t1);
  fe_mulw<ModP>(y3, 21u, y3);
  fe_mul<ModP>(t4, y3, x3);
  fe_mul<ModP>(t3, t1, t2);
  fe_sub<ModP>(t2, x3, x3);
  fe_mul<ModP>(y3, t0, y3);
  fe_mul<ModP>(t1, z3, t1);
  fe_add<ModP>(t1, y3, y3);
  fe_mul<ModP>(t0, t3, t0);
  fe_mul<ModP>(z3, t4, z3);
  fe_add<ModP>(z3, t0, z3);
  fe_copy(r.x, x3);
  fe_copy(r.y, y3);
  fe_copy(r.z, z3);
}

// r = 2p, RCB Algorithm 9.  r may alias p.
template <class F = FieldCanon>
__device__ __forceinline__ void pt_double(const Pt& p, Pt& r) {
  u32 t0[8], t1[8], t2[8], x3[8], y3[8], z3[8];
  F::sqr(p.y, t0);
  F::add(t0, t0, z3);
  F::add(z3, z3, z3);
  F::add(z3, z3, z3);
  F::mul(p.y, p.z, t1);
  F::sqr(p.z, t2);
  F::mulw(t2, 21u, t2);
  F::mul(t2, z3, x3);
  F::add(t0, t2, y3);
  F::mul(t1, z3, z3);
  F::add(t2, t2, t1);
  F::add(t1, t2, t2);
  F::sub(t0, t2, t0);
  F::mul(t0, y3, y3);
  F::add(x3, y3, y3);
  F::mul(p.x, p.y, t1);
  F::mul(t0, t1, x3);
  F::add(x3, x3, x3);
  fe_copy(r.x, x3);
  fe_copy(r.y, y3);
  fe_copy(r.z, z3);
}

// p = the identity (0, 1, 0).
__device__ __forceinline__ void pt_set_identity(Pt& p) {
  fe_set_small(p.x, 0);
  fe_set_small(p.y, 1);
  fe_set_small(p.z, 0);
}

// A per-lane table of E projective points in global memory, int32
// [E, 3, 16, lanes] of 16-bit limbs, lane-minor: the 32 threads of a warp
// read 32 adjacent words of each limb row (coalesced).
template <int E>
struct LaneTable {
  const int* base;
  int lanes, lane;

  // sel |= entry e where mag == e + 1, over all E entries: every lane reads
  // every entry in the same order, so no address or trip count depends on
  // the (possibly secret) digit.
  __device__ __forceinline__ void scan(u32 mag, Pt& sel) const {
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
      const u32 mask = 0u - (u32)(mag == (u32)(e + 1));
      const int* ent = base + (size_t)e * 48 * lanes + lane;
      u32 w[8];
      load_fe(ent, lanes, 0, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) sel.x[k] |= w[k] & mask;
      load_fe(ent + (size_t)16 * lanes, lanes, 0, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) sel.y[k] |= w[k] & mask;
      load_fe(ent + (size_t)32 * lanes, lanes, 0, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) sel.z[k] |= w[k] & mask;
    }
  }
};

// A per-lane table [P, 2P, .., EP] built in the thread's local memory from
// P: 1 doubling and E - 2 complete adds.
template <int E>
struct LocalTable {
  Pt t[E];

  template <class F = FieldCanon>
  __device__ __forceinline__ void build(const Pt& p) {
    pt_copy(t[0], p);
    pt_double<F>(t[0], t[1]);
#pragma unroll 1
    for (int e = 2; e < E; ++e) pt_add<F>(t[e - 1], t[0], t[e]);
  }

  // Every entry copied once from a lane-minor table in global memory, int32
  // [E, 3, 16, lanes] (the layout LaneTable reads).
  __device__ __forceinline__ void load(const int* base, int lanes, int lane) {
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
      const int* ent = base + (size_t)e * 48 * lanes;
      pt_load(ent, ent + (size_t)16 * lanes, ent + (size_t)32 * lanes, lanes,
              lane, t[e]);
    }
  }

  __device__ __forceinline__ void scan(u32 mag, Pt& sel) const {
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
      const u32 mask = 0u - (u32)(mag == (u32)(e + 1));
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sel.x[k] |= t[e].x[k] & mask;
        sel.y[k] |= t[e].y[k] & mask;
        sel.z[k] |= t[e].z[k] & mask;
      }
    }
  }
};

