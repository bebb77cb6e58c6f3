#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched ECDSA verify on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py            # the checks and timings below
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

It imports `secp256k1_tpu_torch` from the checkout (never JAX, never the
JAX package) and runs, each phase printing its lines and any failure ending
the run with a non-zero exit code:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the five kernels from `ops/cuda/csrc` (one nvcc per
   source, in parallel) and prints the seconds and each kernel's registers;
3. kernels: each kernel against its plain PyTorch version on the card at
   65,536 lanes (edge values included), bit-exact, with its device time
   (profiler, cold L2) beside its wrapper's and its plain version's time (CUDA
   events) and its bound; the GLV and fixed-base results of a few
   lanes also against python-int curve arithmetic;
4. main path: `verify_batch_arrays` on 65,536 lanes with 33-byte keys and
   with 65-byte mixed keys, every status against the expected one, with the
   launch counts set to 0 before each call and read after it;
5. throughput: verify/s of `_verify_impl` from planes, and end to end
   (host parse included);
6. a `kernels` JSON line, then the `ok` JSON line last.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 65536
N_DISTINCT = 256
SEED = 20261016

# Published H100 SXM figures used for the bounds (NVIDIA data sheet; CUDA
# C++ Programming Guide, arithmetic instruction throughput for compute
# capability 9.0: 64 results per clock per SM for 32-bit integer
# multiply-add).  The SM count and maximum SM clock are read from the card.
HBM_BYTES_PER_S = 3.35e12
INT_MAD_PER_CLOCK_PER_SM = 64

# 32 x 32 -> 64-bit products per lane, counted from csrc/field.cuh and
# csrc/point.cuh (a product by a constant word 1 compiles to no multiply):
# schoolbook 64, square 36; the fold mod p (c = 2^32 + 977) 8 + 2 + 1 + 1,
# mod n (c of five words, the top one 1) 32 + 20 + 4 + 4; a product by
# b3 = 21 is 8 + 1 + 1.
MUL_P, SQR_P, MUL_N, SQR_N, MULW_P = 64 + 12, 36 + 12, 64 + 60, 36 + 60, 10
PT_ADD = 12 * MUL_P + 2 * MULW_P          # RCB Algorithm 7
PT_ADD_MIXED = 11 * MUL_P + 2 * MULW_P    # Algorithm 8
PT_DOUBLE = 2 * SQR_P + 6 * MUL_P + MULW_P  # Algorithm 9

PALLAS = "secp256k1_tpu/ops/pallas/kernels.py"
CSRC = "secp256k1_tpu_torch/ops/cuda/csrc"
KERNEL_META = {
    "mod_mul": (f"{CSRC}/modops.cu", f"{PALLAS}:1366"),
    "mod_square": (f"{CSRC}/modops.cu", f"{PALLAS}:1371"),
    "mod_pow2k": (f"{CSRC}/modops.cu", f"{PALLAS}:784"),
    "glv_windowed_mult_signed_from_points": (f"{CSRC}/glv.cu",
                                             f"{PALLAS}:1135"),
    "base_windowed_add_final": (f"{CSRC}/base.cu", f"{PALLAS}:1070"),
}
# The __global__ function each wrapper launches (its profiler row).
KERNEL_SYMBOL = {
    "mod_mul": "k_mod_mul",
    "mod_square": "k_mod_square",
    "mod_pow2k": "k_mod_pow2k",
    "glv_windowed_mult_signed_from_points": "k_glv_signed",
    "base_windowed_add_final": "k_base_final",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str):
    """(mean device milliseconds of one launch, launches seen) of the CUDA
    kernel whose name holds `kernel`, over reps calls of fn(), from
    torch.profiler's device rows: the kernel alone, without the host's cost
    of launching it.  The 50 MB L2 cache is flushed before each call, so
    the kernel reads its inputs from HBM, as its byte bound assumes.  The
    profiler may lose a few records of long kernels: the mean is over the
    launches it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    count = sum(ev.count for ev in rows)
    if count == 0:
        fail(f"the profiler recorded no launch of {kernel}")
    return sum(ev.self_device_time_total for ev in rows) / count / 1e3, count


# ---------------------------------------------------------------------------
# Phase 1-2: device and build.
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    say(smi("name,power.limit"))
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int_rate = props.multi_processor_count * INT_MAD_PER_CLOCK_PER_SM \
        * sm_clock_mhz * 1e6
    say(f"device: {torch.cuda.get_device_name(0)}, "
        f"{props.multi_processor_count} SMs, max SM clock {sm_clock_mhz} MHz,"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peak 32-bit integer multiply-add {int_rate:.4g}/s")
    return int_rate


def import_port():
    sys.path.insert(0, HERE)
    try:
        import secp256k1_tpu_torch
    except ImportError as exc:
        fail(f"the port is not beside this script ({exc}): run it from the "
             "root of a checkout")
    pkg = os.path.dirname(os.path.abspath(secp256k1_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "secp256k1_tpu_torch"):
        fail(f"imported the port from {pkg}, not from this checkout")


def phase_build():
    from secp256k1_tpu_torch.ops.cuda import build
    build.build_all()
    say(f"build: {len(build.sources())} sources in "
        f"{build.BUILD_SECONDS:.2f} s into {build.build_dir()}")
    for fn, rep in sorted(build.ptxas_report().items()):
        say(f"ptxas {rep['source']}.cu {fn}: {rep.get('registers')} "
            f"registers, {rep.get('stack')} bytes stack, "
            f"{rep.get('spill_stores')} bytes spill stores, "
            f"{rep.get('spill_loads')} bytes spill loads")


# ---------------------------------------------------------------------------
# Host-side test data (python ints).
# ---------------------------------------------------------------------------

class HostCurve:
    """k*G by 256 precomputed doublings, for making signatures quickly."""

    def __init__(self):
        from secp256k1_tpu_torch.utils import hostcurve as hc
        self.hc = hc
        self.pow2 = [hc.G]
        for _ in range(255):
            self.pow2.append(hc.add(self.pow2[-1], self.pow2[-1]))

    def g_mul(self, k: int):
        acc = None
        for i in range(256):
            if (k >> i) & 1:
                acc = self.hc.add(acc, self.pow2[i])
        return acc


def make_triples(curve: HostCurve, rng: np.random.Generator):
    """N_DISTINCT (pub (x, y), digest, r, s) with low s, plus one whose
    R has x >= n, so that only the r + n < p branch accepts it."""
    hc = curve.hc
    n = hc.N

    def rand_scalar():
        return int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1

    out = []
    for i in range(N_DISTINCT):
        d = rand_scalar()
        digest = hashlib.sha256(b"chip smoke %d" % i).digest()
        e = int.from_bytes(digest, "big") % n
        while True:
            k = rand_scalar()
            r = curve.g_mul(k)[0] % n
            s = pow(k, n - 2, n) * (e + r * d) % n
            if r and s:
                break
        out.append((curve.g_mul(d), digest, r, min(s, n - s)))
    # x_R in [n, p): pick such an R (its discrete log is unknown) and
    # solve u1*G + u2*Q = R for the key: Q = r^-1 (s R - e G).
    x = n
    while True:
        x += 1
        big_r = hc.lift_x(x, False)
        if big_r is not None:
            break
    r = x - n
    digest = hashlib.sha256(b"chip smoke r+n<p").digest()
    e = int.from_bytes(digest, "big") % n
    s = rand_scalar()
    s = min(s, n - s)
    r_inv = pow(r, n - 2, n)
    q = hc.add(hc.mul(s * r_inv % n, big_r),
               hc.neg(curve.g_mul(e * r_inv % n)))
    out.append((q, digest, r, s))
    return out


def non_residue_x(hc) -> int:
    x = 5
    while pow((x ** 3 + 7) % hc.P, (hc.P - 1) // 2, hc.P) != hc.P - 1:
        x += 1
    return x


def build_batch(triples, lanes: int, wide: bool, rng, hc):
    """Tile the triples over the lanes and corrupt known lanes.  Returns
    (pubs, digests, sigs, lens, expected)."""
    from secp256k1_tpu_torch.models import codecs
    from secp256k1_tpu_torch.utils import errors as ec
    n = hc.N
    nd = len(triples)
    pubs = np.zeros((lanes, 65 if wide else 33), np.uint8)
    digests = np.zeros((lanes, 32), np.uint8)
    sigs = np.zeros((lanes, 72), np.uint8)
    lens = np.zeros((lanes,), np.int32)
    expected = np.full((lanes,), ec.OK, np.int32)

    def put_sig(i, r, s):
        der = codecs.build_asn1_signature(r, s)
        sigs[i] = 0
        sigs[i, :len(der)] = np.frombuffer(der, np.uint8)
        lens[i] = len(der)

    def encode(point, compressed):
        raw = hc.encode_point(point, compressed=compressed)
        row = np.zeros((pubs.shape[1],), np.uint8)
        row[:len(raw)] = np.frombuffer(raw, np.uint8)
        return row

    # Distinct rows, then tiled copies (numpy, not per-lane python).  A
    # wide batch takes the uncompressed encoding on even tiles and the
    # zero-padded compressed one on odd tiles.
    cmp_rows = np.stack([encode(t[0], True) for t in triples])
    for t, (_, digest, r, s) in enumerate(triples):
        digests[t] = np.frombuffer(digest, np.uint8)
        put_sig(t, r, s)
    src = np.arange(lanes) % nd
    pubs[:] = cmp_rows[src]
    if wide:
        unc_rows = np.stack([encode(t[0], False) for t in triples])
        unc = (np.arange(lanes) // nd) % 2 == 0
        pubs[unc] = unc_rows[src[unc]]
    digests[:] = digests[src]
    sigs[:] = sigs[src]
    lens[:] = lens[src]

    picks = rng.permutation(np.arange(nd, lanes))
    per_kind = max(2, lanes // 1024)
    kinds = iter(range(0, 7 * per_kind, per_kind))

    def lanes_for():
        lo = next(kinds)
        return picks[lo:lo + per_kind]

    x_bad = non_residue_x(hc)
    for i in lanes_for():                   # flipped digest bit
        digests[i, 5] ^= 0x10
        expected[i] = ec.ERR_V_NEQ_R
    for i in lanes_for():                   # high s under reject_malleable
        _, _, r, s = triples[src[i]]
        put_sig(i, r, n - s)
        expected[i] = ec.ERR_MALLEABLE
    for i in lanes_for():                   # bad key prefix
        pubs[i, 0] = 0x05
        expected[i] = ec.ERR_INVALID_PUBLIC_KEY
    for i in lanes_for():                   # x not on the curve
        if pubs[i, 0] == 0x04:
            y = int.from_bytes(pubs[i, 33:65].tobytes(), "big")
            pubs[i, 33:65] = np.frombuffer(((y + 1) % hc.P).to_bytes(
                32, "big"), np.uint8)
        else:
            pubs[i, 1:33] = np.frombuffer(x_bad.to_bytes(32, "big"),
                                          np.uint8)
        expected[i] = ec.ERR_INVALID_PUBLIC_KEY
    for i in lanes_for():                   # malformed DER
        sigs[i, 0] = 0x31
        expected[i] = ec.ERR_INVALID_ENCODING
    for i in lanes_for():                   # r >= n
        _, _, _, s = triples[src[i]]
        put_sig(i, n + 1, s)
        expected[i] = ec.ERR_INVALID_SCALAR
    for i in lanes_for():                   # compressed key of the wrong y
        if pubs[i, 0] in (0x02, 0x03):
            pubs[i, 0] ^= 0x01
            expected[i] = ec.ERR_V_NEQ_R
    return pubs, digests, sigs, lens, expected


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def random_planes(rng, lanes, modulus, device):
    """[16, lanes] canonical planes: edge values first, then random values
    below 2^256 - 2^240 (< p and < n)."""
    from secp256k1_tpu_torch.ops import limbs as lb
    arr = rng.integers(0, 1 << 16, size=(16, lanes), dtype=np.int64)
    arr[15] = np.minimum(arr[15], 0xFFFE)
    m = modulus
    edge = [0, 1, 2, m - 1, m - 2, 2 ** 255 % m, (m >> 1) + 1]
    arr[:, :len(edge)] = lb.int_to_limbs_batch(edge)
    return torch.as_tensor(arr, dtype=torch.int32, device=device)


def max_abs_err(got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(got, want)]
    return max(errs)


def kernel_checks(int_rate, curve, rng, device):
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import glv
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import modring
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.ops import scalar as sc
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    hc = curve.hc
    lanes = LANES
    lane_bytes = 16 * 4
    res = {}

    def bound(products_total, bytes_total):
        t_ops = products_total / int_rate * 1e3
        t_bytes = bytes_total / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes \
            else (t_bytes, "bytes")

    def record(name, err, call, plain_call, reps, plain_reps,
               products_total, bytes_total, label):
        """Check, then time: the kernel's device time (profiler), the
        wrapper's and the plain version's time per call (CUDA events)."""
        if err != 0:
            fail(f"{label}: kernel differs from its plain version, max abs "
                 f"err {err}")
        ms, seen = kernel_device_ms(call, reps, KERNEL_SYMBOL[name])
        wrapper_ms = cuda_ms(call, reps)
        plain_ms = cuda_ms(plain_call, plain_reps,
                           warmup=1 if plain_reps > 1 else 0)
        b_ms, b_by = bound(products_total, bytes_total)
        say(f"kernel {label}: bit-exact at {lanes} lanes, {ms:.4f} ms device"
            f" with a cold L2 (mean of {seen} of {reps} launches; wrapper "
            f"call {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms), bound "
            f"{b_ms:.4f} ms by {b_by}")
        prev = res.get(name)
        if prev is None:
            res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)

    # Field kernels, p and n.  The JSON keeps the first (mod p) time.
    chain_ks = []

    class _Chain:                       # records the pow2k steps of a chain
        def mul(self, a, b):
            return a

        def pow2k(self, x, k):
            chain_ks.append(k)
            return x

    for e in (fe.P - 2, sc.N - 2, (fe.P - 3) // 4):
        modring.ModRing.pow_const_chain(_Chain(), None, e)
    k_long = max(chain_ks)

    for modulus, tag, mul_c, sqr_c in ((fe.P, "p", MUL_P, SQR_P),
                                       (sc.N, "n", MUL_N, SQR_N)):
        a = random_planes(rng, lanes, modulus, device)
        b = random_planes(rng, lanes, modulus, device).flip(1).contiguous()
        got = K.mod_mul(a, b, modulus)
        want = K.mod_mul_plain(a, b, modulus)
        record("mod_mul", max_abs_err([got], [want]),
               lambda: K.mod_mul(a, b, modulus),
               lambda: K.mod_mul_plain(a, b, modulus), 50, 5,
               mul_c * lanes, 3 * lane_bytes * lanes, f"mod_mul mod {tag}")
        got = K.mod_square(a, modulus)
        want = K.mod_square_plain(a, modulus)
        record("mod_square", max_abs_err([got], [want]),
               lambda: K.mod_square(a, modulus),
               lambda: K.mod_square_plain(a, modulus), 50, 5,
               sqr_c * lanes, 2 * lane_bytes * lanes,
               f"mod_square mod {tag}")
        for k in sorted({k_long, 2, 5}, reverse=True):
            got = K.mod_pow2k(a, k, modulus)
            want = K.mod_pow2k_plain(a, k, modulus)
            record("mod_pow2k", max_abs_err([got], [want]),
                   lambda: K.mod_pow2k(a, k, modulus),
                   lambda: K.mod_pow2k_plain(a, k, modulus), 20, 2,
                   k * sqr_c * lanes, 2 * lane_bytes * lanes,
                   f"mod_pow2k k={k} mod {tag}")

    # GLV kernel at the operands verify gives it: u2 * Q with Q affine
    # (Z = 1), from tiled host points and random scalars.
    n_pts = 64
    pts = [curve.g_mul(int.from_bytes(rng.bytes(32), "big") % hc.N or 1)
           for _ in range(n_pts)]
    idx = torch.arange(lanes, device=device) % n_pts
    qx = torch.as_tensor(lb.int_to_limbs_batch([p[0] for p in pts]),
                         dtype=torch.int32, device=device)[:, idx]
    qy = torch.as_tensor(lb.int_to_limbs_batch([p[1] for p in pts]),
                         dtype=torch.int32, device=device)[:, idx]
    q = pt.Point(qx.contiguous(), qy.contiguous(),
                 fe.one((lanes,), device))
    u2 = random_planes(rng, lanes, sc.N, device)
    d1, d2, p1, p2 = glv.glv_kernel_operands(u2, q)
    name = "glv_windowed_mult_signed_from_points"
    got = K.glv_windowed_mult_signed_from_points(d1, d2, p1, p2)
    want = K.glv_windowed_mult_signed_from_points_plain(d1, d2, p1, p2)
    adds = 12 * lanes + int(((d2[0] & 0xF) != 0).sum()) \
        + int(((d1[1:] & 0xF) != 0).sum()) + int(((d2[1:] & 0xF) != 0).sum())
    doubles = (2 + 4 * (d1.shape[0] - 1)) * lanes
    record(name, max_abs_err(got, want),
           lambda: K.glv_windowed_mult_signed_from_points(d1, d2, p1, p2),
           lambda: K.glv_windowed_mult_signed_from_points_plain(
               d1, d2, p1, p2), 5, 1,
           adds * PT_ADD + doubles * PT_DOUBLE,
           (2 * d1.shape[0] * 4 + 9 * lane_bytes) * lanes, "glv")
    u2_ints = lb.limbs_to_int_batch(u2[:, :24])
    u2q = [hc.mul(k, pts[i % n_pts]) for i, k in enumerate(u2_ints)]
    check_points(got, u2q, hc, "glv")
    u2p = pt.Point(*got)

    # Fixed-base kernel: u1*G + u2*Q with the GLV result as Q.
    u1 = random_planes(rng, lanes, sc.N, device)
    digits = tbl._signed_digits(u1).contiguous()
    table = tbl.base_table(device)
    name = "base_windowed_add_final"
    got = K.base_windowed_add_final(digits, table, *u2p)
    want = K.base_windowed_add_final_plain(digits, table, *u2p)
    mixed = int(((digits[1:] & 0xFFFF) != 0).sum())
    record(name, max_abs_err(got, want),
           lambda: K.base_windowed_add_final(digits, table, *u2p),
           lambda: K.base_windowed_add_final_plain(digits, table, *u2p),
           10, 2, mixed * PT_ADD_MIXED + lanes * PT_ADD,
           (digits.shape[0] * 4 + 6 * lane_bytes) * lanes
           + table.numel() * 4, "base")
    u1_ints = lb.limbs_to_int_batch(u1[:, :24])
    check_points(got, [hc.add(curve.g_mul(k), u2q[i])
                       for i, k in enumerate(u1_ints)], hc, "base")
    say(f"pow2k: the longest run of squarings in the inversion and square "
        f"root chains is k={k_long}")
    return res


def check_points(planes, expect, hc, label):
    """The first len(expect) lanes of projective (X, Y, Z) planes against
    python-int affine points (None for the identity)."""
    from secp256k1_tpu_torch.ops import limbs as lb
    n = len(expect)
    xs, ys, zs = (lb.limbs_to_int_batch(c[:, :n]) for c in planes)
    for i, want in enumerate(expect):
        got = None
        if zs[i] != 0:
            zi = pow(zs[i], hc.P - 2, hc.P)
            got = (xs[i] * zi % hc.P, ys[i] * zi % hc.P)
        if got != want:
            fail(f"{label}: lane {i} differs from python-int arithmetic")
    say(f"kernel {label}: {n} lanes agree with python-int curve arithmetic")


# ---------------------------------------------------------------------------
# Phase 4-5: main path and throughput.
# ---------------------------------------------------------------------------

def main_path(triples, rng, hc, wide):
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    pubs, digests, sigs, lens, expected = build_batch(
        triples, LANES, wide, rng, hc)
    K.reset_counts()
    got = ecdsa.verify_batch_arrays(pubs, digests, sigs, lens,
                                    reject_malleable=True)
    launches = dict(K.LAUNCHES)
    plain = dict(K.PLAIN_CALLS)
    label = f"{pubs.shape[1]}-byte keys"
    if got.shape != expected.shape:
        fail(f"main path ({label}): status shape {got.shape}")
    bad = np.nonzero(got != expected)[0]
    if bad.size:
        fail(f"main path ({label}): {bad.size} lanes with a wrong status, "
             f"first {bad[:5].tolist()}: got {got[bad[:5]].tolist()}, "
             f"expected {expected[bad[:5]].tolist()}")
    counts = {int(c): int((expected == c).sum()) for c in np.unique(expected)}
    say(f"main path ({label}): verify_batch_arrays on {LANES} lanes, every "
        f"status as expected {counts}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path ({label}): kernels not launched: {missing}")
    if any(plain.values()):
        fail(f"main path ({label}): plain versions called: {plain}")
    say(f"main path ({label}): launches per {LANES}-lane verify batch "
        f"{launches}; plain-version calls {plain}")
    return launches, (pubs, digests, sigs, lens)


def core_planes(triples, lanes, device):
    """(qx, qy, e, r, s) planes of `lanes` lanes tiled from the triples."""
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.ops import limbs as lb
    idx = torch.arange(lanes, device=device) % len(triples)

    def tile(vals):
        return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=torch.int32,
                               device=device)[:, idx].contiguous()
    return (tile([t[0][0] for t in triples]), tile([t[0][1] for t in triples]),
            tile([ecdsa.hash_to_scalar_int(t[1]) for t in triples]),
            tile([t[2] for t in triples]), tile([t[3] for t in triples]))


def throughput(triples, arrays, device):
    from secp256k1_tpu_torch.models import ecdsa
    # The core is bound by the host's launch rate, which varies with the
    # host's load: time each call alone, alternate the two widths, and
    # keep the median of each.
    args = {lanes: core_planes(triples, lanes, device)
            for lanes in (LANES // 2, LANES)}
    times = {lanes: [] for lanes in args}
    for lanes, a in args.items():
        st = ecdsa._verify_impl(*a)
        if int((st != 0).sum()):
            fail(f"_verify_impl rejected valid lanes at {lanes} lanes")
    for _ in range(7):
        for lanes, a in args.items():
            times[lanes].append(cuda_ms(lambda: ecdsa._verify_impl(*a), 1,
                                        warmup=0))
    med = {lanes: sorted(t)[len(t) // 2] for lanes, t in times.items()}
    slope = (med[LANES] - med[LANES // 2]) / (LANES // 2)
    say(f"throughput: _verify_impl from planes {med[LANES]:.3f} ms at "
        f"{LANES} lanes (median of 7, range {min(times[LANES]):.3f}-"
        f"{max(times[LANES]):.3f}) = {LANES / med[LANES] * 1e3:.1f} verify/s;"
        f" {med[LANES // 2]:.3f} ms at {LANES // 2} lanes; slope "
        f"{slope * 1e3:.4f} us/lane")

    pubs, digests, sigs, lens = arrays
    walls, parses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ecdsa._e2e_host_parse(pubs, sigs, lens)
        t1 = time.perf_counter()
        ecdsa.verify_batch_arrays(pubs, digests, sigs, lens,
                                  reject_malleable=True)
        walls.append(time.perf_counter() - t1)
        parses.append(t1 - t0)
    wall, parse = sorted(walls)[2], sorted(parses)[2]
    say(f"throughput: verify_batch_arrays end to end {wall * 1e3:.1f} ms "
        f"(median of 5, range {min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f})"
        f" at {LANES} lanes = {LANES / wall:.1f} verify/s; its host "
        f"strict-DER parse alone {parse * 1e3:.1f} ms (median of 5); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def profile_core(triples, device):
    """Device time by kernel name over one _verify_impl call, and the idle
    share of that call: 1 - device busy time / the span from its first
    device activity's start to its last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from secp256k1_tpu_torch.models import ecdsa
    args = core_planes(triples, LANES, device)
    ecdsa._verify_impl(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        ecdsa._verify_impl(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    spans = [ev.time_range for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    if not spans:
        fail("profile: the profiler recorded no device activity")
    busy = sum(s.elapsed_us() for s in spans) / 1e3
    span = (max(s.end for s in spans) - min(s.start for s in spans)) / 1e3
    say(f"profile: _verify_impl at {LANES} lanes under the profiler: "
        f"{len(spans)} device activities, busy {busy:.3f} ms of a "
        f"{span:.3f} ms device span ({wall * 1e3:.3f} ms host wall): idle "
        f"share {1 - busy / span:.3f}")
    for dev_us, key, count in rows[:12]:
        say(f"profile:   {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:80]}")


def main():
    t_start = time.perf_counter()
    int_rate = phase_device()
    import_port()
    phase_build()
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    curve = HostCurve()
    res = kernel_checks(int_rate, curve, rng, device)

    t0 = time.perf_counter()
    triples = make_triples(curve, rng)
    say(f"main path: {len(triples)} distinct signatures made in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, arrays = main_path(triples, rng, curve.hc, wide=False)
    main_path(triples, rng, curve.hc, wide=True)
    throughput(triples, arrays, device)
    if "--profile" in sys.argv[1:]:
        profile_core(triples, device)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "secp256k1_tpu.")))
    if leaked or "secp256k1_tpu" in sys.modules:
        fail(f"the port pulled in {leaked[:5]}")
    kernels = []
    for name in K.KERNELS:
        src, replaces = KERNEL_META[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **res[name], "library_ms": None})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
