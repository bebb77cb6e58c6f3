// The exponentiation chain of k_mod_pow_chain (modops.cu): x^e mod m for a
// public constant e, as a list of steps that the host derives from e alone
// (ops/cuda/kernels.py pow_chain_steps).  A plain C++ compiler builds it
// too, so the CPU tests can run it against python ints and the plain
// version.
//
// A step is one word: k (bits 0-11), src (12-17), mul (18-23) and dst
// (24-29), each of the last three a slot index or POW_ACC.  It computes
//   acc = slot[src]            unless src is POW_ACC (keep acc)
//   acc = acc^(2^k)            k squarings, k may be 0
//   acc = acc * slot[mul]      unless mul is POW_ACC
//   slot[dst] = acc            unless dst is POW_ACC
// Slot 0 holds x; the others hold the chain's intermediates x^(2^r - 1).
// The value after the last step is x^e.  The slots are an array indexed by
// the step's fields, so they live in the thread's local memory; every
// branch, trip count and slot address depends on the step list only, the
// same for every lane and every input, never on x.
#pragma once

#include "field.cuh"

constexpr int POW_MAX_STEPS = 64;
constexpr int POW_MAX_SLOTS = 24;
constexpr u32 POW_ACC = 63;

template <class M>
__device__ __forceinline__ void pow_chain(const u32* steps, int n_steps,
                                          u32 acc[8]) {
  u32 slot[POW_MAX_SLOTS][8];
  fe_copy(slot[0], acc);
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const u32 st = steps[s];
    const u32 k = st & 0xFFFu;
    const u32 src = (st >> 12) & 63u;
    const u32 mul = (st >> 18) & 63u;
    const u32 dst = (st >> 24) & 63u;
    if (src != POW_ACC) fe_copy(acc, slot[src]);
#pragma unroll 1
    for (u32 i = 0; i < k; ++i) fe_sqr<M>(acc, acc);
    if (mul != POW_ACC) fe_mul<M>(acc, slot[mul], acc);
    if (dst != POW_ACC) fe_copy(slot[dst], acc);
  }
}
