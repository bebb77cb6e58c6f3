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
#pragma once

#include "field.cuh"

struct Pt {
  u32 x[8], y[8], z[8];
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

// r = p + q, RCB Algorithm 7.  r may alias p or q.
__device__ __forceinline__ void pt_add(const Pt& p, const Pt& q, Pt& r) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], x3[8], y3[8], z3[8];
  fe_mul<ModP>(p.x, q.x, t0);
  fe_mul<ModP>(p.y, q.y, t1);
  fe_mul<ModP>(p.z, q.z, t2);
  fe_add<ModP>(p.x, p.y, t3);
  fe_add<ModP>(q.x, q.y, t4);
  fe_mul<ModP>(t3, t4, t3);
  fe_add<ModP>(t0, t1, t4);
  fe_sub<ModP>(t3, t4, t3);
  fe_add<ModP>(p.y, p.z, t4);
  fe_add<ModP>(q.y, q.z, x3);
  fe_mul<ModP>(t4, x3, t4);
  fe_add<ModP>(t1, t2, x3);
  fe_sub<ModP>(t4, x3, t4);
  fe_add<ModP>(p.x, p.z, x3);
  fe_add<ModP>(q.x, q.z, y3);
  fe_mul<ModP>(x3, y3, x3);
  fe_add<ModP>(t0, t2, y3);
  fe_sub<ModP>(x3, y3, y3);
  fe_add<ModP>(t0, t0, x3);
  fe_add<ModP>(x3, t0, t0);
  fe_mulw<ModP>(t2, 21u, t2);
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
__device__ __forceinline__ void pt_double(const Pt& p, Pt& r) {
  u32 t0[8], t1[8], t2[8], x3[8], y3[8], z3[8];
  fe_sqr<ModP>(p.y, t0);
  fe_add<ModP>(t0, t0, z3);
  fe_add<ModP>(z3, z3, z3);
  fe_add<ModP>(z3, z3, z3);
  fe_mul<ModP>(p.y, p.z, t1);
  fe_sqr<ModP>(p.z, t2);
  fe_mulw<ModP>(t2, 21u, t2);
  fe_mul<ModP>(t2, z3, x3);
  fe_add<ModP>(t0, t2, y3);
  fe_mul<ModP>(t1, z3, z3);
  fe_add<ModP>(t2, t2, t1);
  fe_add<ModP>(t1, t2, t2);
  fe_sub<ModP>(t0, t2, t0);
  fe_mul<ModP>(t0, y3, y3);
  fe_add<ModP>(x3, y3, y3);
  fe_mul<ModP>(p.x, p.y, t1);
  fe_mul<ModP>(t0, t1, x3);
  fe_add<ModP>(x3, x3, x3);
  fe_copy(r.x, x3);
  fe_copy(r.y, y3);
  fe_copy(r.z, z3);
}
