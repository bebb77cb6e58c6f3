"""The CUDA kernels' field cores and point formulas, compiled for the host.

`secp256k1_tpu_torch/ops/cuda/csrc/field.cuh` writes every multi-word sum,
difference and product as PTX carry chains; compiled by a plain C++
compiler it emulates the same primitives with a carry variable.  This
file builds it, `point.cuh` and the kernels' per-thread bodies with g++
into a small library (a harness below, one C function a formula over
arrays of 8-word values) and holds it against python ints (the field
operations mod p and mod n, the deferred reductions of `FieldLazy`, the
exponentiation chain, the edge values of `tests/test_kernel_bodies.py`
among them) and against the port's plain versions (`ops/cuda/kernels.py`:
the same projective X, Y, Z that the kernels must give on the card, under
each field policy).  Tolerance 0 throughout.

What this cannot see: the PTX itself (nvcc is not needed here) and the
kernels' memory layouts; `chip_smoke.py` holds every kernel against its
plain version on the card.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops.cuda import build
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

torch.set_num_threads(1)

P, N = hc.P, hc.N

HARNESS = r"""
#include <vector>

#include "base.cuh"
#include "bip340.cu"
#include "drbg.cuh"
#include "glv.cuh"
#include "modops.cuh"
#include "msm.cuh"
#include "xmd.cu"

template <class M>
static void field_op(int op, const u32* a, const u32* b, u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    const u32* x = a + 8 * i;
    const u32* y = b + 8 * i;
    u32* r = out + 8 * i;
    switch (op) {
      case 0: fe_mul<M>(x, y, r); break;
      case 1: fe_sqr<M>(x, r); break;
      case 2: fe_add<M>(x, y, r); break;
      case 3: fe_sub<M>(x, y, r); break;
      case 4: fe_neg<M>(x, r); break;
      case 5: fe_mulw<M>(x, 21u, r); break;
    }
  }
}

extern "C" void reduce_ops(int mod, const u32* r, u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    if (mod == 0) reduce_wide<ModP>(r + 16 * i, out + 8 * i);
    else reduce_wide<ModN>(r + 16 * i, out + 8 * i);
  }
}

extern "C" void field_ops(int op, int mod, const u32* a, const u32* b,
                          u32* out, int n) {
  if (mod == 0) field_op<ModP>(op, a, b, out, n);
  else field_op<ModN>(op, a, b, out, n);
}

// The mod-p field operations under the point formulas, by policy: 0
// FieldCanon, 1 FieldLazy; op as field_ops (0 mul, 1 sqr, 2 add, 3 sub, 5 mulw21) or 6 canon.
template <class F>
static void policy_op(int op, const u32* x, const u32* y, u32* r) {
  switch (op) {
    case 0: F::mul(x, y, r); break;
    case 1: F::sqr(x, r); break;
    case 2: F::add(x, y, r); break;
    case 3: F::sub(x, y, r); break;
    case 5: F::mulw(x, 21u, r); break;
    case 6: F::canon(x, r); break;
  }
}

extern "C" void policy_ops(int policy, int op, const u32* a, const u32* b,
                           u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    const u32* x = a + 8 * i;
    const u32* y = b + 8 * i;
    u32* r = out + 8 * i;
    if (policy == 0) policy_op<FieldCanon>(op, x, y, r);
    else policy_op<FieldLazy>(op, x, y, r);
  }
}

static Pt unpack(const u32* w) {
  Pt p;
  for (int k = 0; k < 8; ++k) {
    p.x[k] = w[k];
    p.y[k] = w[8 + k];
    p.z[k] = w[16 + k];
  }
  return p;
}

// op 0 pt_add, 1 pt_double, 2 pt_add_mixed, 3 four pt_double (k_point_dbl4)
// under the field operations F, the result made canonical.
template <class F>
static void point_op(int op, const Pt& p, const Pt& q, Pt& r) {
  if (op == 0) pt_add<F>(p, q, r);
  else if (op == 1) pt_double<F>(p, r);
  else if (op == 2) pt_add_mixed(p, q.x, q.y, r);
  else {
    r = p;
    for (int k = 0; k < 4; ++k) pt_double<F>(r, r);
  }
  pt_canon<F>(r);
}

extern "C" void point_ops(int policy, int op, const u32* a, const u32* b,
                          u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    Pt p = unpack(a + 24 * i), q = unpack(b + 24 * i), r;
    if (policy == 0) point_op<FieldCanon>(op, p, q, r);
    else point_op<FieldLazy>(op, p, q, r);
    for (int k = 0; k < 8; ++k) {
      out[24 * i + k] = r.x[k];
      out[24 * i + 8 + k] = r.y[k];
      out[24 * i + 16 + k] = r.z[k];
    }
  }
}

// k_mod_pow_chain lane by lane: the chain of `steps` on 8-word values.
extern "C" void pow_chain_ops(int mod, const u32* steps, int n_steps,
                              const u32* a, u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    u32 x[8];
    for (int k = 0; k < 8; ++k) x[k] = a[8 * i + k];
    if (mod == 0) pow_chain<ModP>(steps, n_steps, x);
    else pow_chain<ModN>(steps, n_steps, x);
    for (int k = 0; k < 8; ++k) out[8 * i + k] = x[k];
  }
}

// k_msm_fold's rounds, their steps one after another: the Horner fold of
// [W, 3, 16] window-sum rows.
extern "C" void msm_fold_rows(const int* rows, int n_windows,
                              int window_bits, int* ox, int* oy, int* oz) {
  Pt acc;
  fold_windows(rows, n_windows, window_bits, acc);
  pt_store(ox, oy, oz, 1, 0, acc);
}

// Whether each round of the fold's two programs may run its steps in any
// order (the warp runs them at once).
extern "C" int fold_programs_ok() {
  return fold_program_ok(kFoldDouble) && fold_program_ok(kFoldAdd);
}

// k_msm_buckets thread by thread.
extern "C" void msm_buckets(const int* digits, const int* px, const int* py,
                            const int* pz, int* out, int n_windows,
                            int n_points, int n_buckets, int signed_digits,
                            int m_slots) {
  const int threads = n_windows * m_slots;
  std::vector<uint4> scratch((size_t)threads * n_buckets * 6);
  for (int t = 0; t < threads; ++t)
    msm_walk(scratch.data() + (size_t)t * n_buckets * 6, digits, px, py, pz,
             out, t / m_slots, t % m_slots, n_points, n_buckets,
             signed_digits, m_slots);
}

// The GLV kernels lane by lane: kind 0 k_glv_signed, 1 k_glv_unsigned
// (p* the points' planes; its loop under FieldLazy, or under policy 0
// FieldCanon), 2 k_glv_tables (p1x, p2x the lane tables;
// its loop under FieldLazy, or under policy 0 FieldCanon).
extern "C" void glv_lanes(int kind, int policy, const int* d1, const int* d2,
                          const int* p1x, const int* p1y, const int* p1z,
                          const int* p2x, const int* p2y, const int* p2z,
                          int* ox, int* oy, int* oz, int lanes,
                          int n_windows) {
  for (int lane = 0; lane < lanes; ++lane) {
    if (kind == 0)
      glv_from_points<true, 8>(d1, d2, p1x, p1y, p1z, p2x, p2y, p2z, ox, oy,
                               oz, lanes, n_windows, lane);
    else if (kind == 1 && policy == 0)
      glv_from_points<false, 15, FieldCanon>(d1, d2, p1x, p1y, p1z, p2x, p2y,
                                          p2z, ox, oy, oz, lanes,
                                          n_windows, lane);
    else if (kind == 1)
      glv_from_points<false, 15, FieldLazy>(d1, d2, p1x, p1y, p1z, p2x, p2y,
                                          p2z, ox, oy, oz, lanes,
                                          n_windows, lane);
    else if (policy == 0)
      glv_from_tables<FieldCanon>(d1, d2, p1x, p2x, ox, oy, oz, lanes,
                                  n_windows, lane);
    else
      glv_from_tables(d1, d2, p1x, p2x, ox, oy, oz, lanes, n_windows, lane);
  }
}

// The fixed-base kernels' window step lane by lane, each window's entry
// gathered from the packed [W, E, 16] word table as k_base_final gathers
// it; for k_base_scan (final_add 0) magnitude 0 selects (0, 0), as its
// one-hot product does.  final_add: + Q at the end (k_base_final).
extern "C" void base_lanes(const int* digits, const int* words,
                           const int* qx, const int* qy, const int* qz,
                           int* ox, int* oy, int* oz, int lanes,
                           int n_windows, int n_entries, int signed_digits,
                           int final_add) {
  for (int lane = 0; lane < lanes; ++lane) {
    Pt acc;
    pt_set_identity(acc);
    for (int w = 0; w < n_windows; ++w) {
      const u32 d = (u32)digits[(size_t)w * lanes + lane];
      const u32 mag = digit_mag(d, signed_digits);
      const int* ent =
          words + ((size_t)w * n_entries + gather_entry(mag, n_entries)) * 16;
      u32 x[8], y[8];
      for (int k = 0; k < 8; ++k) {
        x[k] = mag || final_add ? (u32)ent[k] : 0u;
        y[k] = mag || final_add ? (u32)ent[8 + k] : 0u;
      }
      base_step(acc, w, mag, digit_neg(d, signed_digits), x, y);
    }
    if (final_add) {
      Pt q;
      pt_load(qx, qy, qz, lanes, lane, q);
      base_final_add(acc, q);
    }
    pt_store(ox, oy, oz, lanes, lane, acc);
  }
}

// k_rfc6979 lane by lane: candidate `attempt` of the DRBG seeded with nd
// (16 or 24) big-endian words a lane.
extern "C" void rfc6979_lanes(const u32* seed, int nd, int attempt,
                              u32* out, int n) {
  for (int i = 0; i < n; ++i) {
    if (nd == 16) rfc6979_lane<16>(seed + 16 * i, attempt, out + 8 * i);
    else rfc6979_lane<24>(seed + 24 * i, attempt, out + 8 * i);
  }
}

// k_bip340_challenge lane by lane over the byte planes r, px [32, n] and
// m [len, n]: each lane's digest as 8 big-endian words.
extern "C" void bip340_lanes(const uint8_t* r, const uint8_t* px,
                             const uint8_t* m, int len, u32* out, int n) {
  for (int i = 0; i < n; ++i)
    bip340_challenge_lane(r, px, m, n, i, len, out + 8 * i);
}

// The kernel's tag midstate.
extern "C" void bip340_midstate(u32* out) {
  for (int i = 0; i < 8; ++i) out[i] = kChallengeMid[i];
}

// k_expand_xmd lane by lane over rows [n, width] and lens [n]: the planes
// [48, (n_out / 48) lanes], lanes past n repeating lane n - 1.
extern "C" void xmd_lanes(const uint8_t* rows, const int* lens, int n,
                          int width, int lanes, const uint8_t* dst_prime,
                          int dst_len, int n_out, uint8_t* out) {
  uint8_t tail[kXmdMaxTail];
  for (int t = 0; t < 3 + dst_len; ++t)
    tail[t] = xmd_tail_byte(dst_prime, n_out, t);
  for (int lane = 0; lane < lanes; ++lane) {
    const int src = lane < n ? lane : n - 1;
    expand_xmd_lane(rows + (size_t)src * width, lens[src], tail, dst_len,
                    n_out, out + lane, lanes,
                    (size_t)(n_out / kXmdPart) * lanes);
  }
}

// The kernel's Z_pad midstate.
extern "C" void xmd_midstate(u32* out) {
  for (int i = 0; i < 8; ++i) out[i] = kZpadMid[i];
}
"""

FIELD_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "neg": 4, "mulw21": 5}
POINT_OPS = {"add": 0, "double": 1, "add_mixed": 2}


@pytest.fixture(scope="module")
def host_lib():
    """The harness built with g++ into build/, keyed by the sources."""
    h = hashlib.sha256(HARNESS.encode())
    for name in ("field.cuh", "point.cuh", "msm.cuh", "glv.cuh", "base.cuh",
                 "modops.cuh", "drbg.cuh", "bip340.cu", "xmd.cu"):
        with open(os.path.join(build.CSRC, name), "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(build.BUILD_ROOT, "host_csrc", h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libcsrchost.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "harness.cpp")
        with open(src, "w") as fh:
            fh.write(HARNESS)
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.run(
            ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall", "-I",
             build.CSRC, "-o", tmp, src],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


def _words(vals):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in words.reshape(-1, 8)]


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _vals(m, rng, k=64):
    """The edge values of tests/test_kernel_bodies.py, values next to
    2^256 - 1 and powers of two (long carry runs), then random ones."""
    edge = [0, 1, 2, m - 1, m - 2, 2**255 % m, (m >> 1) + 1,
            2**32 - 1, 2**64 - 1, 2**224 - 1, m - 2**32]
    rand = [int.from_bytes(rng.bytes(32), "big") % m
            for _ in range(k - len(edge))]
    return edge + rand


def _field_want(op, m, a, b):
    return {"mul": a * b, "sqr": a * a, "add": a + b, "sub": a - b,
            "neg": -a, "mulw21": 21 * a}[op] % m


@pytest.mark.parametrize("mod", ["p", "n"])
@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_core_matches_python_ints(host_lib, op, mod):
    m = P if mod == "p" else N
    rng = np.random.default_rng(FIELD_OPS[op] * 2 + (mod == "n"))
    a = _vals(m, rng)
    b = _vals(m, rng)[::-1]
    # every pair of edge values, then the random pairs
    a, b = zip(*([(x, y) for x in a[:11] for y in a[:11]]
                 + list(zip(a[11:], b[11:]))))
    out = np.zeros((len(a), 8), np.uint32)
    aw, bw = _words(a), _words(b)
    host_lib.field_ops(FIELD_OPS[op], int(mod == "n"), _ptr(aw), _ptr(bw),
                       _ptr(out), len(a))
    assert _ints(out) == [_field_want(op, m, x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_field_mul_takes_any_input_below_2_256(host_lib, op):
    """fe_mul and fe_sqr accept non-canonical inputs < 2^256, words of all
    ones among them (every carry of the product chains taken)."""
    rng = np.random.default_rng(5)
    a = [2**256 - 1 - v for v in range(8)] + [
        (2**256 - 1) ^ (0xFFFFFFFF << (32 * k)) for k in range(8)] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(48)]
    b = a[::-1] if op == "mul" else a
    for mod, m in ((0, P), (1, N)):
        out = np.zeros((len(a), 8), np.uint32)
        host_lib.field_ops(FIELD_OPS[op], mod, _ptr(_words(a)),
                           _ptr(_words(b)), _ptr(out), len(a))
        assert _ints(out) == [x * y % m for x, y in zip(a, b)]


def test_reduction_of_any_512_bit_value(host_lib):
    """reduce_wide on 512-bit values whose words are 0, 2^32 - 1, 2^32 -
    977, 2^32 - 1954 or random: the rare carries of the folds (a chain
    that ends at 2^32 - 1 and takes one more carry) come from such words."""
    rng = np.random.default_rng(6)
    choices = np.array([0, 2**32 - 1, 2**32 - 977, 2**32 - 1954],
                       dtype=np.uint64)
    words = np.where(rng.random((2048, 16)) < 0.8,
                     choices[rng.integers(0, 4, (2048, 16))],
                     rng.integers(0, 2**32, (2048, 16), dtype=np.uint64))
    words[0] = 2**32 - 1
    words = words.astype(np.uint32)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in words]
    for mod, m in ((0, P), (1, N)):
        out = np.zeros((len(vals), 8), np.uint32)
        host_lib.reduce_ops(mod, _ptr(words), _ptr(out), len(vals))
        assert _ints(out) == [v % m for v in vals]


POLICIES = {"canon": 0, "lazy": 1}
POLICY_CASES = [("lazy", op) for op in ("mul", "sqr", "add", "sub", "mulw21",
                                        "canon")]


@pytest.mark.parametrize("policy,op", POLICY_CASES,
                         ids=[f"{c}-{o}" for c, o in POLICY_CASES])
def test_field_cores_match_python_ints(host_lib, policy, op):
    """The point formulas' other field operations mod p: the deferred
    reductions of FieldLazy (below 2^256 and congruent; `canon`
    canonical).  Operands: every pair of the edge values
    of tests/test_kernel_bodies.py and of values in [p, 2^256) (each
    operand near 2^256 takes the second fold), then random 256-bit pairs."""
    rng = np.random.default_rng(10 + 7 * POLICIES[policy] + len(op))
    edge = [0, 1, 2, P - 1, P - 2, 2**255 % P, (P >> 1) + 1, P, P + 1,
            2**256 - 1, 2**256 - 2, 2**256 - 2**32 - 1, 2**32 + 976]
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(1536)]
    a = [x for x in edge for _ in edge] + rand
    b = [y for _ in edge for y in edge] + rand[::-1]
    aw, bw = _words(a), _words(b)
    out = np.zeros_like(aw)
    code = 6 if op == "canon" else FIELD_OPS[op]
    host_lib.policy_ops(POLICIES[policy], code, _ptr(aw), _ptr(bw),
                        _ptr(out), len(a))
    got = _ints(out)
    if op == "canon":
        assert got == [x % P for x in a]
        return
    assert [v % P for v in got] == [_field_want(op, P, x, y)
                                    for x, y in zip(a, b)]


def _point_operands(rng, lanes=48):
    """Projective (P, Q) with random Z: random pairs, P == Q, P == -Q,
    the identity (0, Z, 0) on either side; Q affine for the mixed add."""
    ks = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
          for _ in range(2 * lanes)]
    a = [hc.mul(k, hc.G) for k in ks[:lanes]]
    b = [hc.mul(k, hc.G) for k in ks[lanes:]]
    b[0:4] = a[0:4]
    b[4:8] = [hc.neg(p) for p in a[4:8]]
    zs = [int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
          for _ in range(2 * lanes)]

    def proj(pts, zz, ident):
        out = []
        for i, (pt, z) in enumerate(zip(pts, zz)):
            out.append((0, z, 0) if i in ident else
                       (pt[0] * z % P, pt[1] * z % P, z))
        return out
    p = proj(a, zs[:lanes], range(8, 10))
    q = proj(b, zs[lanes:], range(10, 12))
    q_aff = [(pt[0], pt[1], 1) for pt in b]
    return p, q, q_aff


def _xyz_words(triples):
    return np.concatenate([_words([t[c] for t in triples])
                           for c in range(3)], axis=1)


def _planes(triples):
    return [torch.as_tensor(lb.int_to_limbs_batch([t[c] for t in triples]),
                            dtype=torch.int32) for c in range(3)]


@pytest.mark.parametrize("op", sorted(POINT_OPS))
def test_point_formulas_match_the_plain_versions(host_lib, op):
    """X, Y, Z word for word against the plain version of the kernel."""
    p, q, q_aff = _point_operands(np.random.default_rng(40 + POINT_OPS[op]))
    if op == "add_mixed":
        q = q_aff
    out = np.zeros((len(p), 24), np.uint32)
    host_lib.point_ops(0, POINT_OPS[op], _ptr(_xyz_words(p)),
                       _ptr(_xyz_words(q)), _ptr(out), len(p))
    pp, qq = _planes(p), _planes(q)
    if op == "add":
        want = K.point_add_plain(*pp, *qq)
    elif op == "double":
        want = K.point_double_plain(*pp)
    else:
        want = K.point_add_mixed_plain(*pp, *qq[:2])
    for c in range(3):
        got = _ints(np.ascontiguousarray(out[:, 8 * c:8 * c + 8]))
        assert got == lb.limbs_to_int_batch(want[c])



CORE_POINT_CASES = [(c, o) for c in POLICIES for o in ("add", "double",
                                                      "double4")]


@pytest.mark.parametrize("policy,op", CORE_POINT_CASES,
                         ids=[f"{c}-{o}" for c, o in CORE_POINT_CASES])
def test_point_formulas_on_each_field_core(host_lib, policy, op):
    """pt_add, pt_double and k_point_dbl4's four doublings under each field
    policy (the result made canonical, as the kernels store it): X, Y, Z
    word for word against the plain versions."""
    rng = np.random.default_rng(50 + 3 * POLICIES[policy] + len(op))
    p, q, _ = _point_operands(rng, 24)
    out = np.zeros((len(p), 24), np.uint32)
    host_lib.point_ops(POLICIES[policy], {"add": 0, "double": 1,
                                          "double4": 3}[op],
                       _ptr(_xyz_words(p)), _ptr(_xyz_words(q)), _ptr(out),
                       len(p))
    pp, qq = _planes(p), _planes(q)
    want = {"add": lambda: K.point_add_plain(*pp, *qq),
            "double": lambda: K.point_double_plain(*pp),
            "double4": lambda: K.point_double4_plain(*pp)}[op]()
    for c in range(3):
        got = _ints(np.ascontiguousarray(out[:, 8 * c:8 * c + 8]))
        assert got == lb.limbs_to_int_batch(want[c])

# ---------------------------------------------------------------------------
# The kernels' per-thread bodies: the bucket walk and the GLV loop.
# ---------------------------------------------------------------------------

# (exponent, modulus): the chains of invert mod p and mod n and of the
# square root, a one-step mod_pow2k (2^95, 2^1), and short ones (3: one
# multiply after a copy; 2^64 + 1: squarings and a multiply in one step).
CHAIN_CASES = {"p-2": (P - 2, P), "n-2": (N - 2, N),
               "(p-3)/4": ((P - 3) // 4, P), "2^95-mod-n": (1 << 95, N),
               "2^1": (2, P), "3-mod-n": (3, N), "2^64+1": ((1 << 64) + 1, P)}


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_pow_chain_matches_python_ints_and_the_plain_version(host_lib,
                                                              name):
    """k_mod_pow_chain's loop (modops.cuh) over the kernel's step words,
    against pow(x, e, m) and `mod_pow_chain_plain`; zero maps to 0."""
    e, m = CHAIN_CASES[name]
    vals = _vals(m, np.random.default_rng(len(name)), 24)
    steps = np.ascontiguousarray(K._pow_chain_words(e).numpy()
                                 .astype(np.uint32))
    out = np.zeros((len(vals), 8), np.uint32)
    host_lib.pow_chain_ops(int(m == N), _ptr(steps), len(steps),
                           _ptr(_words(vals)), _ptr(out), len(vals))
    assert _ints(out) == [pow(v, e, m) for v in vals]
    plain = K.mod_pow_chain_plain(
        torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=torch.int32), e,
        m)
    assert _ints(out) == lb.limbs_to_int_batch(plain)


def _fold_case(case):
    """(rows int32 [W, 3, 16], window bits): "w4" W = 4, w = 4; "w8" W = 3,
    w = 8 (random points, random Z); "edge" w = 4, least significant
    window first: B, B, the identity (0, Z, 0), the identity (0, 1, 0),
    16 A (equal to the accumulator at its add), A; "cancel" w = 4: C,
    -16 A (the accumulator's negation at its add), A."""
    rng = np.random.default_rng({"w4": 1, "w8": 2, "edge": 3, "cancel": 4}[case])
    a, b, c = (hc.mul(int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1,
                      hc.G) for _ in range(3))
    if case in ("w4", "w8"):
        w, n = (4, 4) if case == "w4" else (8, 3)
        pts = [hc.mul(int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1,
                      hc.G) for _ in range(n)]
    elif case == "edge":
        w, pts = 4, [b, b, None, None, hc.mul(16, a), a]
    else:
        w, pts = 4, [c, hc.neg(hc.mul(16, a)), a]
    zs = [int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1 for _ in pts]
    xyz = [(0, 1 if i == 3 and case == "edge" else z, 0) if q is None
           else (q[0] * z % P, q[1] * z % P, z)
           for i, (q, z) in enumerate(zip(pts, zs))]
    rows = torch.stack([plane.t() for plane in _planes(xyz)],
                       dim=1).contiguous()
    return rows, w


@pytest.mark.parametrize("case", ["w4", "w8", "edge", "cancel"])
def test_fold_matches_the_plain_version(host_lib, case):
    """k_msm_fold's rounds (msm.cuh), run step by step: X, Y, Z word for
    word against `msm_fold_plain`.  The warp runs each round's steps at
    once, which gives the same values only if no step of a round writes a
    register another step of it reads or writes."""
    assert host_lib.fold_programs_ok() == 1
    rows, w = _fold_case(case)
    outs = [np.zeros((16, 1), np.int32) for _ in range(3)]
    host_lib.msm_fold_rows(_ptr(_np32(rows)), rows.shape[0], w,
                           *[_ptr(o) for o in outs])
    for got, want in zip(outs, K.msm_fold_plain(rows, w)):
        assert np.array_equal(got, want.numpy())


def _np32(t):
    return np.ascontiguousarray(t.numpy().astype(np.int32))


def _affine_planes(rng, n):
    """Random points a_i * G with random Z, as int32 [16, n] planes."""
    pts = [hc.mul(int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1, hc.G)
           for _ in range(n)]
    zs = [int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
          for _ in range(n)]
    return _planes([(q[0] * z % P, q[1] * z % P, z)
                    for q, z in zip(pts, zs)])


# (signed, n_buckets, n_points, m_slots): a 4-bit unsigned window, signed
# 5- and 6-bit windows, a ragged N, three slots, one slot, and fewer
# points than slots (slots that see no point keep the identity).
MSM_CASES = [(False, 15, 96, 16), (True, 16, 80, 16), (True, 32, 77, 8),
             (False, 15, 31, 3), (True, 16, 40, 1), (False, 15, 24, 40),
             (True, 32, 40, 48), (False, 15, 101, 7)]


@pytest.mark.parametrize("signed,nb,n,m", MSM_CASES,
                         ids=["w4", "signed-w5", "signed-w6-ragged",
                              "w4-3-slots", "signed-w5-1-slot",
                              "w4-fewer-points-than-slots",
                              "signed-w6-fewer-points-than-slots",
                              "w4-ragged-7-slots"])
def test_bucket_walk_matches_the_plain_version(host_lib, signed, nb, n, m):
    """Digits that hit every bucket, 0, and magnitudes above nb (which the
    kernel must discard without touching a bucket), against
    `msm_bucket_accumulate_all_plain`."""
    rng = np.random.default_rng(nb * 1000 + n)
    n_windows = 3
    digits = rng.integers(0, nb + 1, (n_windows, n))
    digits[0, :nb + 1] = np.arange(nb + 1)             # every bucket and 0
    over = rng.random((n_windows, n)) < 0.15
    digits[over] = rng.integers(nb + 1, 64, int(over.sum()))
    if signed:
        digits |= rng.integers(0, 2, (n_windows, n)) << 6
    else:
        digits[1, :4] = [64, 65, 1 << 20, 2**31 - 1]     # far above nb
    digits = torch.as_tensor(digits, dtype=torch.int32)
    px, py, pz = _affine_planes(rng, n)
    py[:, 5] = py[:, 4]                                # a repeated point
    px[:, 5], pz[:, 5] = px[:, 4], pz[:, 4]
    want = K.msm_bucket_accumulate_all_plain(digits, px, py, pz, nb, signed,
                                             m)
    out = np.zeros((n_windows, nb, 3, 16, m), np.int32)
    d, x, y, z = (_np32(t) for t in (digits, px, py, pz))
    host_lib.msm_buckets(_ptr(d), _ptr(x), _ptr(y), _ptr(z), _ptr(out),
                         n_windows, n, nb, int(signed), m)
    assert np.array_equal(out, want.numpy())


def _glv_digits(rng, n_windows, lanes, signed):
    if signed:
        mag = rng.integers(0, 9, (n_windows, lanes))
        return mag | (rng.integers(0, 2, (n_windows, lanes)) << 4)
    return rng.integers(0, 16, (n_windows, lanes))


@pytest.mark.parametrize("kind", ["signed", "unsigned", "tables"])
def test_glv_lanes_match_the_plain_versions(host_lib, kind):
    """The three GLV kernels' lane body at 8 windows: all-zero digit
    columns, magnitude 0 with the sign bit set (window 0 too), magnitude 8
    of either sign, the identity (0, Z, 0) as P1 or P2."""
    _check_glv_lanes(host_lib, kind, POLICIES["lazy"])


@pytest.mark.parametrize("policy", ["canon"])
def test_unsigned_glv_lane_on_each_field_core(host_lib, policy):
    """k_glv_unsigned's lane body under the other field policy than the
    kernel's own: the same X, Y, Z."""
    _check_glv_lanes(host_lib, "unsigned", POLICIES[policy])


def test_table_glv_lane_on_the_canonical_field_core(host_lib):
    """k_glv_tables' lane body under FieldCanon, the policy it ran on
    before FieldLazy: the same X, Y, Z."""
    _check_glv_lanes(host_lib, "tables", POLICIES["canon"])


def _check_glv_lanes(host_lib, kind, policy):
    rng = np.random.default_rng({"signed": 1, "unsigned": 2, "tables": 3}[kind])
    lanes, n_windows, signed = 12, 8, kind == "signed"
    d1 = _glv_digits(rng, n_windows, lanes, signed)
    d2 = _glv_digits(rng, n_windows, lanes, signed)
    d1[:, 0] = 0                                       # all-zero columns
    d2[:, 1] = 0
    if signed:
        d1[:, 2] = 16                                  # magnitude 0, sign 1
        d2[0, 3] = 16
        d1[:, 4], d2[:, 4] = 8, 8 | 16                 # magnitude 8
    else:
        d1[:, 4], d2[:, 4] = 15, 15
    d1, d2 = (torch.as_tensor(d, dtype=torch.int32) for d in (d1, d2))
    p1, p2 = _affine_planes(rng, lanes), _affine_planes(rng, lanes)
    for p, lane in ((p1, 5), (p2, 6)):                 # the identity
        p[1][:, lane] = p[2][:, lane]
        p[0][:, lane] = 0
        p[2][:, lane] = 0
    if kind == "tables":
        from secp256k1_tpu_torch.ops import point as pt
        from secp256k1_tpu_torch.ops import table as tbl
        t1, t2 = (tbl.build_lane_table(pt.Point(*p)) for p in (p1, p2))
        want = K.glv_windowed_mult_plain(d1, d2, t1, t2)
        ops = [_np32(t1), None, None, _np32(t2), None, None]
    else:
        plain = (K.glv_windowed_mult_signed_from_points_plain if signed
                 else K.glv_windowed_mult_from_points_plain)
        want = plain(d1, d2, tuple(p1), tuple(p2))
        ops = [_np32(c) for c in list(p1) + list(p2)]
    outs = [np.zeros((16, lanes), np.int32) for _ in range(3)]
    a1, a2 = _np32(d1), _np32(d2)
    host_lib.glv_lanes({"signed": 0, "unsigned": 1, "tables": 2}[kind],
                       policy, _ptr(a1), _ptr(a2),
                       *[None if o is None else _ptr(o) for o in ops],
                       *[_ptr(o) for o in outs], lanes, n_windows)
    for got, w in zip(outs, want):
        assert np.array_equal(got, w.numpy())


# (window bits, signed, final add): k_base_scan at the signed widths 6, 8
# and 12 and the unsigned width 8; k_base_final at the signed ones.
BASE_CASES = [(8, True, False), (8, True, True), (6, True, False),
              (6, True, True), (12, True, False), (12, True, True),
              (8, False, False)]


@pytest.mark.parametrize(
    "bits,signed,final", BASE_CASES,
    ids=[f"{'final' if f else 'scan'}-{'signed' if s else 'unsigned'}-w{b}"
         for b, s, f in BASE_CASES])
def test_base_window_step_matches_the_plain_versions(host_lib, bits, signed,
                                                     final):
    """The fixed-base kernels' window step (base.cuh) over every window of
    the G table at 10 lanes, X, Y, Z word for word against
    `base_windowed_add_plain` / `base_windowed_add_final_plain` (both the
    loop of `_base_accumulate_plain`).  Edge lanes in every window: 0 the
    all-zero scalar, 1 magnitude 0 with the sign bit set, 2 magnitude 1,
    3 magnitude E (the last entry), 4 magnitude E with the sign bit set;
    the rest random magnitudes and signs; Q the identity on lane 5."""
    from secp256k1_tpu_torch.ops import table as tbl
    rng = np.random.default_rng(bits * 10 + signed * 2 + final)
    table = tbl.base_table("cpu", bits, signed)
    n_windows, n_entries = table.shape[:2]
    lanes = 10
    mag = rng.integers(0, n_entries + 1, (n_windows, lanes))
    mag[:, :2] = 0
    mag[:, 2] = 1
    mag[:, 3:5] = n_entries
    sign = rng.integers(0, 2, (n_windows, lanes)) if signed \
        else np.zeros((n_windows, lanes), np.int64)
    sign[:, 0] = sign[:, 3] = 0
    if signed:
        sign[:, 1] = sign[:, 4] = 1
    digits = torch.as_tensor(mag | (sign << 16), dtype=torch.int32)
    q = _affine_planes(rng, lanes)
    q[1][:, 5] = q[2][:, 5]                            # Q the identity
    q[0][:, 5] = 0
    q[2][:, 5] = 0
    if final:
        want = K.base_windowed_add_final_plain(digits, table, *q)
    else:
        want = K.base_windowed_add_plain(digits, table, signed)
    words = _np32(tbl.base_table_words("cpu", bits, signed))
    outs = [np.zeros((16, lanes), np.int32) for _ in range(3)]
    d = _np32(digits)
    qs = [_np32(c) for c in q]
    host_lib.base_lanes(_ptr(d), _ptr(words), *[_ptr(c) for c in qs],
                        *[_ptr(o) for o in outs], lanes, n_windows,
                        n_entries, int(signed), int(final))
    for got, w in zip(outs, want):
        assert np.array_equal(got, w.numpy())


@pytest.mark.parametrize("extra", [False, True])
def test_drbg_lanes_match_the_native_drbg(host_lib, extra):
    """k_rfc6979's lane body (drbg.cuh) at 16 lanes, candidates 0, 1 and
    2, byte for byte against the native library's DRBG and its
    continuation, seeded with key || e, or with 32 bytes of additional
    data after them."""
    from secp256k1_tpu_torch import native
    rng = np.random.default_rng(17 + extra)
    lanes = 16
    rows = [rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
            for _ in range(3 if extra else 2)]
    seed = np.concatenate(rows, 1).view(">u4").astype(np.uint32)
    want, sv, sk = native.rfc6979_nonce_batch(*rows)
    for attempt in range(3):
        if attempt:
            want = np.stack([native.rfc6979_continue(sv, sk, i)
                             for i in range(lanes)])
        out = np.zeros((lanes, 8), np.uint32)
        host_lib.rfc6979_lanes(_ptr(seed), seed.shape[1], attempt, _ptr(out),
                               lanes)
        assert np.array_equal(out.astype(">u4").view(np.uint8), want)


# Message lengths of the challenge hash: 55 bytes are the most whose
# padding fits the block after R.x || P.x, 56 the fewest that spill into
# another.
BIP340_LENGTHS = [0, 1, 32, 55, 56, 64, 100]


@pytest.mark.parametrize("length", BIP340_LENGTHS)
def test_bip340_challenge_lanes_match_hashlib_and_native(host_lib, length):
    """k_bip340_challenge's lane body (bip340.cu) at 16 lanes of seeded
    random rows, byte for byte against hashlib's SHA256(t || t || r || px
    || m) and the native library's tagged hash."""
    from secp256k1_tpu_torch import native
    rng = np.random.default_rng(340 + length)
    lanes = 16
    rows = [rng.integers(0, 256, (lanes, w), dtype=np.uint8)
            for w in (32, 32, length)]
    planes = [np.ascontiguousarray(a.T) for a in rows]
    out = np.zeros((lanes, 8), np.uint32)
    host_lib.bip340_lanes(*[_ptr(p) for p in planes], length, _ptr(out),
                          lanes)
    got = out.astype(">u4").view(np.uint8)
    t = hashlib.sha256(K.BIP340_CHALLENGE_TAG).digest()
    want = [hashlib.sha256(t + t + b"".join(a[i].tobytes() for a in rows))
            .digest() for i in range(lanes)]
    assert [g.tobytes() for g in got] == want
    assert np.array_equal(got, native.tagged_hash_batch(
        K.BIP340_CHALLENGE_TAG, *rows, lanes))


def test_bip340_tag_midstate_is_the_tags_compression(host_lib):
    """The kernel's constant midstate is the compression of SHA256(tag) ||
    SHA256(tag) from the IV: the plain compression gives it, and its
    compression of the padding of those 64 bytes is hashlib's digest."""
    mid = np.zeros(8, np.uint32)
    host_lib.bip340_midstate(_ptr(mid))
    t = hashlib.sha256(K.BIP340_CHALLENGE_TAG).digest()
    words = [int(w) for w in np.frombuffer(t + t, ">u4")]
    assert mid.tolist() == K._sha256_block_plain(list(K._SHA256_IV), words)
    final = K._sha256_block_plain(mid.tolist(),
                                  [0x80000000] + [0] * 14 + [64 * 8])
    assert b"".join(w.to_bytes(4, "big") for w in final) == \
        hashlib.sha256(t + t).digest()


# The hash-to-curve suites' DST (J.8.1), a 255-byte DST (the longest hashed
# as it is) and an oversize one, which the host reduces to 32 bytes.
XMD_DSTS = {"dst49": b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_",
            "dst255": bytes(range(1, 256)), "dst300": b"x" * 300}


@pytest.mark.parametrize("n_out", [48, 96])
@pytest.mark.parametrize("dst", sorted(XMD_DSTS))
def test_expand_xmd_lanes_match_the_jax_expansion(host_lib, dst, n_out):
    """k_expand_xmd's lane body (xmd.cu) on every length 0-600 (so b0's
    block edges after the midstate under the suite's DST, lengths 2/3,
    66/67, 130/131, and 517 among them) in rows 640 bytes wide, the bytes
    past each length not zero, and 9 padded lanes: each lane's planes
    against the JAX package's one-message expand_message_xmd, the padded
    lanes equal to the last message's."""
    from secp256k1_tpu.models import h2c as jh2c
    from secp256k1_tpu_torch.models import h2c
    dst = XMD_DSTS[dst]
    reduced, _ = h2c._dst_and_ell(dst, n_out)
    dst_prime = np.frombuffer(reduced + bytes([len(reduced)]), np.uint8)
    rng = np.random.default_rng(9380 + n_out + len(dst))
    width, n, lanes = 640, 601, 610
    rows = rng.integers(1, 256, (n, width), dtype=np.uint8)
    lens = np.arange(n, dtype=np.int32)
    parts = n_out // 48
    out = np.zeros((48, parts * lanes), np.uint8)
    host_lib.xmd_lanes(_ptr(rows), _ptr(lens), n, width, lanes,
                       _ptr(dst_prime), dst_prime.size, n_out, _ptr(out))
    got = out.reshape(48, parts, lanes).transpose(2, 1, 0).reshape(lanes, -1)
    for i in range(lanes):
        m = rows[min(i, n - 1), :lens[min(i, n - 1)]].tobytes()
        assert got[i].tobytes() == jh2c.expand_message_xmd(m, dst, n_out), i


def test_xmd_zpad_midstate_is_the_compression_of_zero_bytes(host_lib):
    """The kernel's constant midstate is the compression of 64 zero bytes
    from the IV: the plain compression gives it, and its compression of
    the padding of those 64 bytes is hashlib's digest."""
    mid = np.zeros(8, np.uint32)
    host_lib.xmd_midstate(_ptr(mid))
    assert mid.tolist() == K._sha256_block_plain(list(K._SHA256_IV), [0] * 16)
    final = K._sha256_block_plain(mid.tolist(),
                                  [0x80000000] + [0] * 14 + [64 * 8])
    assert b"".join(w.to_bytes(4, "big") for w in final) == \
        hashlib.sha256(bytes(64)).digest()
