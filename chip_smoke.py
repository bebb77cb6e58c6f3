#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched ECDSA verify, sign and recover, its
BIP-0340 sign and verify, its batched ECDH, its Pippenger and Straus MSM,
the engines behind the JAX package's switches, its RFC 9380 hash-to-curve,
Bitcoin consensus verify and verify service, and its sharded verify and
MSM on `torch.distributed`, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and g++:

    python3 chip_smoke.py            # the checks and timings below
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns
    python3 chip_smoke.py --cores    # only the device cores' times
    python3 chip_smoke.py --glv      # only the three GLV kernels' times

It imports `secp256k1_tpu_torch` from the checkout (never JAX, never the
JAX package) and runs, each phase printing its lines and any failure ending
the run with a non-zero exit code:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from `ops/cuda/csrc` (one nvcc per source,
   in parallel) and the native host library (g++), and prints the
   seconds, each kernel's registers, stack and spills, each kernel's SASS
   instructions by kind (IMAD.WIDE beside the rest), the IMMA (int8
   tensor-core) instructions in `k_base_scan`'s SASS (`cuobjdump -sass`;
   none fails the run) and the resident blocks an SM of the fixed-base
   kernels, `k_point_add` (fewer than 4 fails) and the chain kernel (more
   than 128 registers or a spill fails);
3. kernels: each kernel against its plain PyTorch version on the card at
   65,536 lanes (edge values included), bit-exact, with its device time
   (profiler, cold L2) beside its wrapper's and its plain version's time (CUDA
   events) and its bound; the GLV, fixed-base and point kernels' results
   of a few lanes also against python-int curve arithmetic; the engine
   kernels (`point_double4`, `point_add_mixed`, `point_lookup_add`, the
   unsigned GLV #7 and the lane-table GLV #9, whose affine result must
   equal #7's and #4's; #7's and #12's edge lanes also in a second warp,
   lanes 128 on, and #7's and #9's device times at all-zero, all-15 and
   random digits, a constant-time witness, printed), and the fixed-base
   kernels at their other shapes
   (#6 unsigned w = 8, signed w = 6 and 12; #5 at w = 6 and 12); #5 and #6
   at every width with edge lanes, each the same digit in every window
   (the all-zero scalar, magnitude 0 with the sign bit set, magnitude 1,
   magnitude E and -E), and #6's bound recounted for its int8 select
   beside the masked scan it replaced, and its device time at all-zero,
   all-E and random digits (a constant-time witness, printed); the
   signed GLV #4 with edge lanes (all-zero digit windows, magnitude 0 with
   the sign bit set, magnitude 8 of either sign, the identity as P1 or
   P2); `point_add` also at the lane merge's widths (491,520 down to 960);
   `mod_pow2k`, the chain kernel's one-step case, at k = 95, 5 and 2; the
   chain kernel `mod_pow_chain` at 65,536 lanes for (p - 3)/4, p - 2 and
   n - 2, at one lane for n - 2 and p - 2 (the root of `invert_batch`),
   at a ragged width, with the edge values, also against python ints, and
   its one-lane device time on 0, m - 1 and a random value (a
   constant-time witness, printed); the bucket kernel bit-exact over
   every partial bucket at 2^14 points in its unsigned (w = 4) and signed
   (w = 5, 6) modes (every bucket hit, magnitudes above the bucket count
   discarded), at a ragged N, with 3 slots, and at 2^20 points (w = 4, the
   MSM path's shape), where it is timed; the fold kernel `msm_fold`,
   projective X, Y, Z bit-exact at the window sums of that 2^20-point
   MSM (W = 64, w = 4), of a sort + scan MSM (W = 32, w = 8) and of edge
   cases (the identity, equal consecutive sums, a sum equal to or the
   negation of the accumulator at its add), those also against python
   ints; the DRBG kernel `k_rfc6979` (RFC 6979's HMAC-DRBG, which the JAX
   package runs on its host) without and with additional data, candidates
   0 and 1, against the native DRBG at 65,536 lanes and its plain version
   at 65,536 and 1,024 lanes, timed at both;
4. paths (65,536 lanes), each with the launch counts set to 0 just before
   it and read just after, failing if a kernel of that path was not
   launched, a plain version was called or `mod_pow2k` was launched (the
   chains are each one `mod_pow_chain` launch now); each path prints its
   chain launches by exponent and width and its one-lane launches:
   - verify: `verify_batch_arrays` with 33-byte keys and with 65-byte mixed
     keys, every status against the expected one, two chain launches
     (the square root and the root of `invert_batch`);
   - ECDSA sign: `sign_batch_arrays` (the 20 RFC 6979 vectors in the batch,
     byte-exact; 256 lanes against a python-int signer; the nonces from the
     DRBG kernel), every signature verified by `verify_batch_arrays`;
   - the wallet signer: `bitcoin.sign_der_batch_arrays` on the same lanes
     with the native DRBG refusing every call, one DRBG launch a round,
     the vectors' lanes and 64 others against `tests/wallet_sign_ref.py`;
   - recover: `recover_batch` gives back every lane's signer;
   - keyed verify: `verify_batch_arrays_keyed` with corrupted lanes, every
     status against the expected one;
   - Schnorr: `sign_batch_arrays` (BIP-0340 vectors 0-3 in the batch,
     byte-exact) and `verify_batch_arrays` (vectors 0-14 in the batch);
   - ECDH: `ecdh_batch_arrays` under the default GLV engine,
     `set_mega_signed(False)` and `set_mega(False)`, every status of the
     corrupted lanes, 256 sampled lanes against python ints and every lane
     against the default engine's bytes;
   - verify and ECDSA sign under `set_base_signed(False)`,
     `set_base_window(4)` and `set_base_window(12)`: every status, and
     every signature equal to the default path's;
   - MSM: `multi_scalar_mult` on 2^20 points (the bucket path, w = 4), a
     signed-window call (w = 5) on the same points (each one fold launch,
     no `point_double` and no one-lane `point_add`), a sort + scan call
     (w = 8) on 2^14 points and `multi_scalar_mult_straus` on 64 points,
     each result against python ints: 256 points a_i * G of known a_i tiled
     over the lanes and a scalar k_j of its own on each lane, so the sum is
     (sum_j k_j a_(j mod 256) mod n) * G;
   - hash-to-curve: `hash_to_curve_batch` and `encode_to_curve_batch` on
     65,536 messages with the RFC 9380 suite vectors at known lanes
     (each its file's P, 256 lanes against a python-int oracle, no
     identity), then `hash_to_curve_batch_arrays` and
     `encode_to_curve_batch_arrays` on the same seeded messages (every
     such lane equal to the list form's), five chain launches a call;
     `swu.set_uniform_bytes` and `swu.iso_map` at 65,536 lanes with edge
     lanes (u = 0, the u where tv2 = 0, u = p - 1, strings >= p, the
     isogeny's pole) against their plain versions on the CPU and python
     ints;
   - consensus verify: `bitcoin.verify_asn1_batch_arrays` on the verify
     batch with a sighash byte after every DER, BIP-0066 vectors that
     must fail, high s and missing sighash bytes planted, every status;
   - the verify service: 65,536 requests from two threads into
     `VerifyService` (max_lanes 16,384), unkeyed and with a key cache of
     256, every future's bool, with requests/s, batches and the
     device-busy share of the wall time;
   every kernel launch of the ECDH, switch, MSM and hash-to-curve arrays
   paths is then held bit-exact against its plain version on the
   operands it was given;
5. throughput: verify/s of `_verify_impl` from planes and end to end (native
   DER parse); sign/s end to end and of `_sign_e2e_core` (its DRBG kernel
   included), beside the native host DRBG's time; recover/s; keyed
   verify/s; Schnorr sign/s and verify/s; MSM points/s at 2^16, 2^20 and
   2^22 points and the bucket kernel's share of the 2^20 call; ECDH/s end
   to end and of `_ecdh_e2e_core` under each GLV engine; the verify and
   sign cores under each fixed-base switch;
   h2c/s end to end, of `expand_message_xmd_batch` alone and of the
   `_ro_bytes_core` and `_nu_bytes_core` device cores; consensus verify
   end to end beside `verify_batch_arrays`; with `--profile`, the device
   time by kernel and the idle share of one `_verify_impl`, one
   `_sign_e2e_core`, one `_ecdh_e2e_core`, one `_ro_bytes_core`, one
   `_nu_bytes_core` and one 2^20-point `multi_scalar_mult` call (the MSM
   and the sign core each in a child process of this script,
   `--profile-msm` and `--profile-sign`);
6. sharding (one card hosts one NCCL rank, so at world size 1, the
   backend and world size printed; the process group destroyed at the
   end): `sharded_verify_fn` on the verify planes of phase 5 with r
   changed on every 8th lane, every gathered status equal to
   `_verify_impl`'s; `sharded_msm` on 2^20 points (w = 4) against python
   ints and, X, Y, Z, `multi_scalar_mult`; the split form on four
   virtual shards of 2^18 points (`local_fn` on each, `_tree_reduce`,
   `combine_windows`) against python ints, and composed against
   `sharded_msm`; the rates beside the unsharded ones and the split
   stages' times; `ModRing.pow_const` (small, chain, random and split
   exponents), `product_lanes`, `sum_lanes` and `bytes_are_canonical`
   mod p and mod n at 65,536 lanes against python ints; the module
   aliases `field.pow_const` and `scalar.pow_const` at e = 2^4096,
   2^5000 + 1, m - 1, m and 2^512 - 1 (reduced below m before the chains
   are built) against the plain ring on every lane and python `pow` on
   edge and sampled lanes; `table.lookup_shared_affine_all` on the w = 8
   signed G table against `lookup_shared_affine` by window and python
   ints; each a path with
   its launches counted and its kernels' launches replayed through their
   plain versions (the 2^20-point bucket walk is replayed by the MSM
   path only); `profiling.trace` of `entry()` in a child process of this
   script, `--trace-entry` (its Chrome trace must name the verify
   kernels), `timed_chain` of `_verify_impl` beside
   phase 5's median and `roofline_report` of `point_add` (its bound must
   be the kernel row's);
7. a `kernels` JSON line (launches summed over the paths, and per path;
   the chain kernel's launches by exponent and width on each path; the
   one-lane `point_add` and `point_double` launches on each path;
   `glv_windowed_mult`, which no path of either package calls, and
   `mod_pow2k`, which no path launches now, with 0), then the `ok` JSON
   line last.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 65536
N_DISTINCT = 256
SEED = 20261016

# The H100 yardstick of the bounds (published rates, products a lane of
# each field and point operation) is the port's own, `utils/profiling.py`,
# so that this script and the port cannot drift apart.
sys.path.insert(0, HERE)
try:
    from secp256k1_tpu_torch.utils.profiling import (  # noqa: E402
        MUL_N, MUL_P, MULW_P, PT_ADD, PT_ADD_MIXED, PT_DOUBLE, SQR_N, SQR_P,
        bound_ms, bound_terms, int8_rate, max_sm_clock_mhz, peak_int_rate)
except ImportError as exc:
    print(f"FAIL: the port is not beside this script ({exc}): run it from "
          "the root of a checkout", flush=True)
    sys.exit(1)

PALLAS = "secp256k1_tpu/ops/pallas/kernels.py"
CSRC = "secp256k1_tpu_torch/ops/cuda/csrc"
KERNEL_META = {
    "mod_mul": (f"{CSRC}/modops.cu", f"{PALLAS}:1366"),
    "mod_square": (f"{CSRC}/modops.cu", f"{PALLAS}:1371"),
    "mod_pow2k": (f"{CSRC}/modops.cu", f"{PALLAS}:784"),
    "glv_windowed_mult_signed_from_points": (f"{CSRC}/glv.cu",
                                             f"{PALLAS}:1135"),
    "base_windowed_add_final": (f"{CSRC}/base.cu", f"{PALLAS}:1070"),
    "base_windowed_add": (f"{CSRC}/base.cu", f"{PALLAS}:1041"),
    "point_add": (f"{CSRC}/point.cu", f"{PALLAS}:1376"),
    "point_double": (f"{CSRC}/point.cu", f"{PALLAS}:1380"),
    "msm_bucket_accumulate_all": (f"{CSRC}/msm.cu", f"{PALLAS}:1232"),
    "glv_windowed_mult_from_points": (f"{CSRC}/glv.cu", f"{PALLAS}:1105"),
    "glv_windowed_mult": (f"{CSRC}/glv.cu", f"{PALLAS}:1266"),
    "point_double4": (f"{CSRC}/point.cu", f"{PALLAS}:1384"),
    "point_add_mixed": (f"{CSRC}/point.cu", f"{PALLAS}:1413"),
    "point_lookup_add": (f"{CSRC}/lookup.cu", f"{PALLAS}:1388"),
    # The chain kernel replaces a chain of mod_pow2k (and mod_mul) calls;
    # the fold 256 point_double (and 64 point_add) one-lane calls at w = 4.
    "mod_pow_chain": (f"{CSRC}/modops.cu", f"{PALLAS}:784"),
    "msm_fold": (f"{CSRC}/msm.cu", f"{PALLAS}:1380"),
    # RFC 6979's DRBG, which the JAX package runs on its host.
    "rfc6979_nonce": (f"{CSRC}/drbg.cu",
                      "none (secp256k1_tpu/native/hostcrypto.cpp)"),
}
# The __global__ function each wrapper launches (its profiler row).
KERNEL_SYMBOL = {
    "mod_mul": "k_mod_mul",
    "mod_square": "k_mod_square",
    "mod_pow2k": "k_mod_pow_chain",
    "glv_windowed_mult_signed_from_points": "k_glv_signed",
    "base_windowed_add_final": "k_base_final",
    "base_windowed_add": "k_base_scan",
    "point_add": "k_point_add",
    "point_double": "k_point_double",
    "msm_bucket_accumulate_all": "k_msm_buckets",
    "glv_windowed_mult_from_points": "k_glv_unsigned",
    "glv_windowed_mult": "k_glv_tables",
    "point_double4": "k_point_dbl4",
    "point_add_mixed": "k_point_mixed",
    "point_lookup_add": "k_lookup_add",
    "mod_pow_chain": "k_mod_pow_chain",
    "msm_fold": "k_msm_fold",
    "rfc6979_nonce": "k_rfc6979",
}
# The kernels each path must launch.  mod_square is launched where a path
# takes a square root (SEC1 decompression, recovery, lift_x).
FIELD_KERNELS = ("mod_mul", "mod_pow_chain")
SQRT_KERNELS = FIELD_KERNELS + ("mod_square",)
GLV_KERNELS = SQRT_KERNELS + ("glv_windowed_mult_signed_from_points",)
VERIFY_KERNELS = GLV_KERNELS + ("base_windowed_add_final",)
# The verify core from affine keys (keyed verify, `_verify_impl`): no root.
VERIFY_CORE_KERNELS = FIELD_KERNELS + (
    "glv_windowed_mult_signed_from_points", "base_windowed_add_final")
SIGN_KERNELS = FIELD_KERNELS + ("base_windowed_add",)
# ECDSA sign derives its nonces on the card: the DRBG kernel first.
ECDSA_SIGN_KERNELS = SIGN_KERNELS + ("rfc6979_nonce",)
POINT_KERNELS = ("point_add", "point_double")
MSM_KERNELS = ("msm_bucket_accumulate_all", "point_add", "msm_fold")
SCAN_KERNELS = ("point_add", "msm_fold")
# Hash-to-curve: the map's products, squares and chains; the RO suite's add.
H2C_NU_KERNELS = SQRT_KERNELS
H2C_RO_KERNELS = SQRT_KERNELS + ("point_add",)
# ECDH under each GLV engine, and verify and sign under each fixed-base
# switch: (label, switch setter arguments, kernels the path must launch).
ECDH_ENGINES = (
    ("default", {}, GLV_KERNELS),
    ("mega_signed=0", {"mega_signed": False},
     SQRT_KERNELS + ("glv_windowed_mult_from_points",)),
    ("mega=0", {"mega": False},
     SQRT_KERNELS + POINT_KERNELS + ("point_double4", "point_lookup_add")),
)
BASE_SWITCHES = (
    ("base_signed=0", {"base_signed": False},
     GLV_KERNELS + ("base_windowed_add", "point_add"), ECDSA_SIGN_KERNELS),
    ("base_window=4", {"base_window": 4},
     GLV_KERNELS + ("point_add_mixed", "point_add"),
     FIELD_KERNELS + ("point_add_mixed", "rfc6979_nonce")),
    ("base_window=12", {"base_window": 12}, VERIFY_KERNELS,
     ECDSA_SIGN_KERNELS),
)
# The kernels that no path launches, driven by the kernel phase only: the
# JAX package's glv_windowed_mult (from prebuilt tables), which no path of
# either package calls, and mod_pow2k, whose chains are now each one
# mod_pow_chain launch (the same CUDA kernel).
NO_PATH_KERNELS = ("glv_windowed_mult", "mod_pow2k")
# The exponents of the chain kernel on the paths: the square root of SEC1
# decompression, and invert mod p and mod n (the root of invert_batch).
P_FIELD = 2**256 - 2**32 - 977
N_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
CHAIN_EXPONENTS = {"(p-3)/4": ((P_FIELD - 3) // 4, P_FIELD),
                   "p-2": (P_FIELD - 2, P_FIELD),
                   "n-2": (N_ORDER - 2, N_ORDER)}
CHAIN_RAGGED = 4099
# mod_pow2k, the chain kernel's one-step case, at the k it had on the paths
# before each chain became one launch: their longest run of squarings, and
# 5 and 2.
POW2K_KS = (95, 5, 2)
# point_add's widths in the 2^20-point MSM's lane merge (W nb = 960 rows).
MERGE_WIDTHS = tuple(960 << j for j in range(9, -1, -1))
CHAIN_LABEL = {e: label for label, (e, _) in CHAIN_EXPONENTS.items()}
MSM_POINTS = 1 << 20             # the MSM path and the bucket kernel's time
MSM_CHECK_POINTS = 1 << 14       # bucket kernel vs plain; sort + scan call
MSM_STRAUS_POINTS = 64
MSM_RATE_SIZES = (1 << 16, 1 << 20, 1 << 22)
# The sharding phase: the split form's virtual shards of the MSM_POINTS
# points (2^18 each, the bucket path at w = 4) and the lanes of each
# pow_const result held against python ints.
SPLIT_SHARDS = 4
SHARD_WINDOW = 4
POW_CONST_CHECK_LANES = 1024
# pow_const's exponents past m - 1 against python pow on the edge lanes and
# sampled ones; lookup_shared_affine_all against python ints on its planted
# lanes and sampled ones.
POW_CONST_EDGE_LANES = 64
POW_CONST_SAMPLED_LANES = 64
LOOKUP_SAMPLED_LANES = 3
PATH_LAUNCHES: dict = {}        # path label -> {kernel: launches}
CHAIN_SHAPES: dict = {}         # path label -> {"exponent at width": n}
ONE_LANE: dict = {}             # path label -> {kernel: one-lane launches}
CORE_ROUNDS = 5                 # --cores: rounds of medians of 7 a core
# The DRBG kernel: checked at LANES lanes, timed at these widths (the sign
# path's first round, and a narrow grind round), on data of its own seed;
# the wallet signer's lanes held to the python-int reference signer.
DRBG_TIMED_WIDTHS = (LANES, 1024)
DRBG_SEED = SEED + 17
WALLET_SAMPLED_LANES = 64
GLV_ROUNDS = 3                  # --glv: rounds of each GLV kernel's times
PROFILE_ATTEMPTS = 5
# Host seconds of quiet at each end of a profiler session, so that no
# device work starts or ends at a session's edge.  Late in a run the
# profiler dropped every device activity of a session up to the end of
# an MSM's 72 ms bucket kernel, with pauses of 0.1 to 1.6 s before the
# work alike, while the same session kept them in a fresh process: the
# profiled MSM runs in a process of its own (`--profile-msm`).  Late in a
# run it also lost `k_rfc6979`, the first launch of `_sign_e2e_core`, from
# every session of that core, whether a kernel of its own opened the
# session or not, while it kept the core's other kernels there and every
# launch of it in a fresh process: the profiled sign core runs in a process
# of its own too (`--profile-sign`).
PROFILE_PAD_S = 0.1
TESTDATA = os.path.join(HERE, "tests", "testdata")
SPLIT_LANE = 128        # edge lanes copied from here on: another warp
SASS_MIX: dict = {}     # kernel name -> SASS instruction counts by kind


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


def profiled(label, fn, expect):
    """(profiler, host seconds of fn()) of one torch.profiler session
    around fn(), with PROFILE_PAD_S of host quiet at each end.  The
    profiler may lose records: a session whose device rows name no kernel
    holding one of `expect` is repeated, up to PROFILE_ATTEMPTS sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        keys = [ev.key for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        missing = [k for k in expect if not any(k in key for key in keys)]
        if not missing:
            return prof, wall
        say(f"profile: {label}: the profiler lost the record of {missing}; "
            f"profiling again")
    fail(f"profile: {label}: no record of {missing} in {PROFILE_ATTEMPTS} "
         f"sessions")


def kernel_device_ms(fn, reps: int, kernel: str):
    """(mean device milliseconds of one launch, launches seen) of the CUDA
    kernel whose name holds `kernel`, over reps calls of fn(), from
    torch.profiler's device rows: the kernel alone, without the host's cost
    of launching it.  The 50 MB L2 cache is flushed before each call, so
    the kernel reads its inputs from HBM, as its byte bound assumes.  The
    mean is over the launches the profiler recorded."""
    from torch.autograd import DeviceType
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()
    prof, _ = profiled(kernel, calls, [kernel])
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    count = sum(ev.count for ev in rows)
    return sum(ev.self_device_time_total for ev in rows) / count / 1e3, count


# ---------------------------------------------------------------------------
# Phase 1-2: device and build.
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    say(smi("name,power.limit"))
    sm_clock_mhz = max_sm_clock_mhz()
    props = torch.cuda.get_device_properties(0)
    int_rate = peak_int_rate(props.multi_processor_count, sm_clock_mhz)
    say(f"device: {torch.cuda.get_device_name(0)}, "
        f"{props.multi_processor_count} SMs, max SM clock {sm_clock_mhz} MHz,"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peak 32-bit integer multiply-add {int_rate:.4g}/s, "
        f"dense int8 MMA {int8_rate(int_rate):.4g} operations/s")
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
    from secp256k1_tpu_torch import native
    from secp256k1_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    native.lib()
    say(f"build: native host library in {time.perf_counter() - t0:.2f} s "
        f"at {native.library_path()}")
    build.build_all()
    say(f"build: {len(build.sources())} sources in "
        f"{build.BUILD_SECONDS:.2f} s into {build.build_dir()}")
    for fn, rep in sorted(build.ptxas_report().items()):
        say(f"ptxas {rep['source']}.cu {fn}: {rep.get('registers')} "
            f"registers, {rep.get('stack')} bytes stack, "
            f"{rep.get('spill_stores')} bytes spill stores, "
            f"{rep.get('spill_loads')} bytes spill loads")
    for lib in build.sources():
        for fn, body in build.sass(lib).items():
            name = kernel_name(fn)
            SASS_MIX[name] = sass_mix(body)
            say(f"sass {lib}.cu {name}: " + ", ".join(
                f"{kind} {n}" for kind, n in SASS_MIX[name].items()))
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    imma = {fn: sum("IMMA" in line for line in body.splitlines())
            for fn, body in build.sass("base").items()}
    scan = sum(n for fn, n in imma.items() if "k_base_scan" in fn)
    say(f"build: IMMA instructions in base.cu's SASS {imma}; "
        f"k_base_scan {scan}")
    if not scan:
        fail("k_base_scan's SASS holds no IMMA instruction: its select is "
             "not on the tensor cores")
    say(f"build: resident blocks of 128 threads an SM: k_base_scan "
        f"{K.blocks_per_sm('base', 'base_blocks_per_sm', 0)}, k_base_final "
        f"{K.blocks_per_sm('base', 'base_blocks_per_sm', 1)}, k_point_add "
        f"{K.blocks_per_sm('point', 'point_add_blocks_per_sm')}, "
        f"k_mod_pow_chain mod p "
        f"{K.blocks_per_sm('modops', 'pow_chain_blocks_per_sm', 0)}, mod n "
        f"{K.blocks_per_sm('modops', 'pow_chain_blocks_per_sm', 1)}")
    report = build.ptxas_report()
    for fn, rep in report.items():
        if "k_mod_pow_chain" in fn and (rep.get("registers", 999) > 128
                                        or rep.get("spill_stores")):
            fail(f"{fn}: {rep}: the chain kernel must take at most 128 "
                 "registers and spill nothing")
    if K.blocks_per_sm("point", "point_add_blocks_per_sm") < 4:
        fail("k_point_add: fewer than 4 blocks of 128 an SM")


def kernel_name(mangled: str) -> str:
    """k_rfc6979<16> from _Z9k_rfc6979ILi16EEv...; k_point_add from
    _Z11k_point_addPKi..."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    if not m:
        return mangled
    name = m.group(2)[:int(m.group(1))]
    rest = m.group(2)[int(m.group(1)):]
    t = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{t.group(1)}>" if t else name


SASS_KINDS = ("IMAD.WIDE", "IMAD", "IADD3", "LOP3", "SHF", "SEL", "PRMT",
              "LDL", "LDL.128", "STL", "STL.128")


def sass_mix(body: str) -> dict:
    """Counts of a kernel's SASS instructions (static, from `cuobjdump
    -sass`) by kind: the multiply-adds that hold a wide product
    (IMAD.WIDE), the other IMADs (moves, adds with carry, IMAD.HI), the
    integer ALU kinds, local loads and stores (16-byte ones
    apart), and the total."""
    counts = collections.Counter()
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if not m:
            continue
        op = m.group(1)
        base = op.split(".")[0]
        kind = "IMAD.WIDE" if op.startswith("IMAD.WIDE") else base
        if base in ("LDL", "STL") and ".128" in op:
            kind = f"{base}.128"
        counts[kind] += 1
        counts["total"] += 1
    return {k: counts[k] for k in SASS_KINDS + ("total",)}


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
    edge = edge[:lanes]
    arr[:, :len(edge)] = lb.int_to_limbs_batch(edge)
    return torch.as_tensor(arr, dtype=torch.int32, device=device)


def random_z(xs, ys, rng, device):
    """Affine planes (x, y) -> projective (xZ, yZ, Z) with a random nonzero
    Z per lane (edge values of Z included)."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import limbs as lb
    lanes = xs.shape[1]
    z = random_planes(rng, lanes, fe.P, device)
    z = torch.where(lb.is_zero(z).unsqueeze(0), fe.one((lanes,), device), z)
    return [fe.mul(xs, z), fe.mul(ys, z), z]


def max_abs_err(got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(got, want)]
    return max(errs)


BASE_EDGE_LANE = 24     # the fixed-base kernels' edge lanes start here


def base_edge_lanes(digits, bits, n_entries, signed):
    """Write the fixed-base kernels' edge lanes into digits [W, B] in place,
    each the same digit in every window, from BASE_EDGE_LANE on: the
    all-zero scalar, magnitude 0 with the sign bit set (signed), magnitude
    1, magnitude E (the last entry) and, signed, magnitude E with the sign
    bit set.  Returns their scalars mod n."""
    from secp256k1_tpu_torch.ops import scalar as sc
    cols = [(0, 0), (1, 1), (n_entries, n_entries)]
    if signed:
        cols[1:1] = [(1 << 16, 0)]
        cols.append((n_entries | 1 << 16, -n_entries))
    weight = sum(1 << (bits * i) for i in range(digits.shape[0]))
    for i, (d, _) in enumerate(cols):
        digits[:, BASE_EDGE_LANE + i] = d
    return [v * weight % sc.N for _, v in cols]


def affine_lanes(planes, lo, n, hc):
    """Lanes lo .. lo + n - 1 of (X, Y, Z) planes as python-int affine
    points (None for Z = 0)."""
    from secp256k1_tpu_torch.ops import limbs as lb
    xs, ys, zs = (lb.limbs_to_int_batch(c[:, lo:lo + n]) for c in planes)
    return [None if z == 0 else
            (x * pow(z, -1, hc.P) % hc.P, y * pow(z, -1, hc.P) % hc.P)
            for x, y, z in zip(xs, ys, zs)]


def base_scan_work(int_rate, digits, table, signed, label):
    """(32-bit products, int8 MMA operations, bytes) of k_base_scan on
    these digits: the mixed adds of the nonzero digits past window 0; the
    select's 2 x E_pad x 64 a lane a window; the digits, the three outputs
    and the byte table.  Prints each term of the bound and, beside them,
    the yardstick of the masked scan it replaced: one LOP3 a word an entry
    a window at the integer rate."""
    from secp256k1_tpu_torch.ops import table as tbl
    n_windows, n_entries = table.shape[:2]
    lanes = digits.shape[1]
    e_pad = tbl.packed_of(table, "bytes").shape[2]
    mag = digits & 0xFFFF if signed else digits
    products = int((mag[1:] != 0).sum()) * PT_ADD_MIXED
    mma = 2 * lanes * e_pad * 64 * n_windows
    nbytes = (n_windows * 4 + 3 * 16 * 4) * lanes + n_windows * 64 * e_pad
    selects = n_windows * n_entries * 16 * lanes
    terms = bound_terms(int_rate, products, nbytes, mma)
    say(f"kernel {label}: {n_windows} windows of {n_entries} entries "
        f"({e_pad} padded): {products} 32-bit products "
        f"{terms['products']:.4f} ms, {mma} int8 MMA operations "
        f"{terms['int8_mma']:.4f} ms, {nbytes} bytes {terms['bytes']:.4f} "
        f"ms (the bound takes the largest); the masked scan it replaced, "
        f"{selects} LOP3 selects, {selects / int_rate * 1e3:.4f} ms")
    return products, mma, nbytes


def kernel_checks(int_rate, curve, rng, device):
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import glv
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.ops import scalar as sc
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    hc = curve.hc
    lanes = LANES
    lane_bytes = 16 * 4
    res = {}

    def record(name, err, call, plain_call, reps, plain_reps,
               products_total, bytes_total, label, mma_ops=0):
        timed_check(int_rate, res, name, label, err, call, plain_call, reps,
                    plain_reps, products_total, bytes_total,
                    mma_ops=mma_ops)

    # Field kernels, p and n.  The JSON keeps the first (mod p) time.

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
        for k in POW2K_KS:
            got = K.mod_pow2k(a, k, modulus)
            want = K.mod_pow2k_plain(a, k, modulus)
            record("mod_pow2k", max_abs_err([got], [want]),
                   lambda: K.mod_pow2k(a, k, modulus),
                   lambda: K.mod_pow2k_plain(a, k, modulus), 20, 2,
                   k * sqr_c * lanes, 2 * lane_bytes * lanes,
                   f"mod_pow2k k={k} mod {tag}")
    chain_checks(int_rate, res, rng, device)

    # GLV kernel at the operands verify gives it: u2 * Q with Q affine
    # (Z = 1), from tiled host points and random scalars.
    n_pts = 64
    pts, qx, qy = tiled_points(curve, rng, lanes, device, n_pts)
    q = pt.Point(qx, qy, fe.one((lanes,), device))
    u2 = random_planes(rng, lanes, sc.N, device)
    d1, d2, p1, p2 = glv.glv_kernel_operands(u2, q)
    d1, d2 = d1.clone(), d2.clone()
    p1, p2 = [c.clone() for c in p1], [c.clone() for c in p2]
    # Edge lanes past the 24 held against python ints: 24 every window of
    # d1 zero, 25 of d2; 26 magnitude 0 with the sign bit set in every
    # window of d1 and in window 0 of d2; 27 magnitude +8 and 28 -8 in
    # every window of both; 29 P1 the identity (0, 1, 0), 30 P2.
    d1[:, 24] = 0
    d2[:, 25] = 0
    d1[:, 26] = 16
    d2[0, 26] = 16
    d1[:, 27] = d2[:, 27] = 8
    d1[:, 28] = d2[:, 28] = 8 | 16
    for pp, lane in ((p1, 29), (p2, 30)):
        pp[0][:, lane] = 0
        pp[1][:, lane] = torch.as_tensor(lb.int_to_limbs_batch([1])[:, 0],
                                         dtype=torch.int32, device=device)
        pp[2][:, lane] = 0
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

    # Fixed-base kernel: u1*G + u2*Q with the GLV result as Q, edge lanes
    # from BASE_EDGE_LANE on (Q there the GLV result of those lanes).
    u1 = random_planes(rng, lanes, sc.N, device)
    digits = tbl._signed_digits(u1).contiguous()
    table = tbl.base_table(device)
    edge_ks = base_edge_lanes(digits, 8, table.shape[1], True)
    name = "base_windowed_add_final"
    got = K.base_windowed_add_final(digits, table, *u2p)
    want = K.base_windowed_add_final_plain(digits, table, *u2p)
    mixed = int(((digits[1:] & 0xFFFF) != 0).sum())
    record(name, max_abs_err(got, want),
           lambda: K.base_windowed_add_final(digits, table, *u2p),
           lambda: K.base_windowed_add_final_plain(digits, table, *u2p),
           10, 2, mixed * PT_ADD_MIXED + lanes * PT_ADD,
           (digits.shape[0] * 4 + 6 * lane_bytes) * lanes
           + table.numel() * 2, "base")
    u1_ints = lb.limbs_to_int_batch(u1[:, :24])
    check_points(got, [hc.add(curve.g_mul(k), u2q[i])
                       for i, k in enumerate(u1_ints)], hc, "base")
    q_edge = affine_lanes(u2p, BASE_EDGE_LANE, len(edge_ks), hc)
    check_points([c[:, BASE_EDGE_LANE:] for c in got],
                 [hc.add(curve.g_mul(k), q) for k, q in zip(edge_ks, q_edge)],
                 hc, "base edge lanes")

    # Constant-time fixed-base kernel: k*G from secret digits.  Beside the
    # edge values: every byte 0x80 (the recoding carry runs through every
    # window), two scalars with zero windows, and the edge lanes.
    ks = random_planes(rng, lanes, sc.N, device)
    extra = [int("80" * 32, 16) % sc.N, (1 << 200) | 5,
             int("01" + "00" * 30 + "01", 16)]
    ks[:, 7:7 + len(extra)] = torch.as_tensor(
        lb.int_to_limbs_batch(extra), dtype=torch.int32, device=device)
    digits = tbl._signed_digits(ks).contiguous()
    edge_ks = base_edge_lanes(digits, 8, table.shape[1], True)
    name = "base_windowed_add"
    got = K.base_windowed_add(digits, table)
    want = K.base_windowed_add_plain(digits, table)
    products, mma, nbytes = base_scan_work(int_rate, digits, table, True,
                                           "base scan")
    record(name, max_abs_err(got, want),
           lambda: K.base_windowed_add(digits, table),
           lambda: K.base_windowed_add_plain(digits, table), 10, 1,
           products, nbytes, "base scan", mma)
    check_points(got, [curve.g_mul(k) for k in
                       lb.limbs_to_int_batch(ks[:, :24])], hc, "base scan")
    check_points([c[:, BASE_EDGE_LANE:] for c in got],
                 [curve.g_mul(k) for k in edge_ks], hc,
                 "base scan edge lanes")

    # Constant-time witness, printed and not gated: the device time at
    # all-zero digits, at magnitude E in every window and at the digits
    # above.
    witness = {}
    for tag, d in (("all-zero", torch.zeros_like(digits)),
                   ("all-E", torch.full_like(digits, table.shape[1])),
                   ("random", digits)):
        witness[tag] = kernel_device_ms(
            lambda d=d: K.base_windowed_add(d, table), 10,
            KERNEL_SYMBOL[name])[0]
    res[name]["constant_time_ms"] = witness
    say("kernel base scan constant-time witness (device ms, cold L2): "
        + ", ".join(f"{tag} {t:.4f}" for tag, t in witness.items()))

    # Point kernels, random Z on both operands: lanes 0-7 P == Q, 8-15
    # P == -Q, 16-19 P the identity (0, Z, 0), 20-23 Q the identity.
    perm = (torch.arange(lanes, device=device) * 7 + 3) % lanes
    p1 = random_z(qx, qy, rng, device)
    p2 = random_z(qx[:, perm].contiguous(), qy[:, perm].contiguous(), rng,
                  device)
    a = [pts[i % n_pts] for i in range(24)]
    b = [pts[int(perm[i]) % n_pts] for i in range(24)]
    for c in range(3):
        p2[c][:, :16] = p1[c][:, :16]
    p2[1][:, 8:16] = fe.neg(p1[1][:, 8:16])
    for pp, sl in ((p1, slice(16, 20)), (p2, slice(20, 24))):
        pp[1][:, sl] = pp[2][:, sl]
        pp[0][:, sl] = 0
        pp[2][:, sl] = 0
    for i in range(24):
        b[i] = a[i] if i < 8 else hc.neg(a[i]) if i < 16 else b[i]
        a[i] = None if 16 <= i < 20 else a[i]
        b[i] = None if 20 <= i < 24 else b[i]
    got = K.point_add(*p1, *p2)
    record("point_add", max_abs_err(got, K.point_add_plain(*p1, *p2)),
           lambda: K.point_add(*p1, *p2),
           lambda: K.point_add_plain(*p1, *p2), 50, 5, PT_ADD * lanes,
           9 * lane_bytes * lanes, "point_add")
    check_points(got, [hc.add(x, y) for x, y in zip(a, b)], hc, "point_add")
    # point_add at the widths of the MSM's lane merge (960 bucket rows
    # times 512 down to 1 slot pairs at 2^20 points, w = 4), the operands
    # the 65,536-lane ones tiled.
    widths = {}
    for width in MERGE_WIDTHS:
        idx = torch.arange(width, device=device) % lanes
        q1 = [c[:, idx].contiguous() for c in p1]
        q2 = [c[:, idx].contiguous() for c in p2]
        widths[width] = timed_check(
            int_rate, res, "point_add", f"point_add at {width} lanes",
            max_abs_err(K.point_add(*q1, *q2), K.point_add_plain(*q1, *q2)),
            lambda: K.point_add(*q1, *q2),
            lambda: K.point_add_plain(*q1, *q2), 20, 1, PT_ADD * width,
            9 * lane_bytes * width, keep=False, lanes=width)
    res["point_add"]["ms_by_width"] = widths
    got = K.point_double(*p1)
    record("point_double", max_abs_err(got, K.point_double_plain(*p1)),
           lambda: K.point_double(*p1), lambda: K.point_double_plain(*p1),
           50, 5, PT_DOUBLE * lanes, 6 * lane_bytes * lanes, "point_double")
    check_points(got, [hc.add(x, x) for x in a], hc, "point_double")
    return res


def drbg_checks(int_rate, res, device):
    """The DRBG kernel `k_rfc6979` (`rfc6979_nonce`) without and with
    additional data, candidates 0 and 1: at LANES lanes against the native
    DRBG on the host (`rfc6979_nonce_batch`, then `rfc6979_continue`), and
    at each of DRBG_TIMED_WIDTHS bit-exact against its plain version on the
    card and timed (profiler, cold L2) beside its bound of 32-bit integer
    operations (`profiling.SHA256_BLOCK_OPS` a compression).  Its data come
    from a generator of its own."""
    from secp256k1_tpu_torch import native
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    from secp256k1_tpu_torch.utils import batching as bt
    from secp256k1_tpu_torch.utils.profiling import (SHA256_BLOCK_OPS,
                                                     rfc6979_blocks)
    name = "rfc6979_nonce"
    rng = np.random.default_rng(DRBG_SEED)
    rows = [rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
            for _ in range(3)]
    rows[1] = ecdsa._reduce_digest_np(rows[1])
    planes = [bt.byte_plane_np(r, LANES, device) for r in rows]
    for extra in (False, True):
        first, sv, sk = native.rfc6979_nonce_batch(*rows[:2 + extra])
        want = [first, np.stack([native.rfc6979_continue(sv, sk, i)
                                 for i in range(LANES)])]
        for attempt in (0, 1):
            tag = (f"{name} {'with' if extra else 'without'} extra data, "
                   f"candidate {attempt}")
            for lanes in DRBG_TIMED_WIDTHS:
                args = [p[:, :lanes].contiguous() for p in planes]
                args = (args[0], args[1], args[2] if extra else None,
                        attempt)
                got = K.rfc6979_nonce(*args)
                if lanes == LANES:
                    wrong = int((got.cpu().numpy().T != want[attempt])
                                .any(axis=1).sum())
                    if wrong:
                        fail(f"kernel {tag}: {wrong} of {LANES} lanes "
                             f"differ from the native DRBG")
                    say(f"kernel {tag}: all {LANES} lanes equal the native "
                        f"DRBG")
                timed_check(int_rate, res, name, f"{tag} at {lanes} lanes",
                            max_abs_err([got],
                                        [K.rfc6979_nonce_plain(*args)]),
                            lambda: K.rfc6979_nonce(*args),
                            lambda: K.rfc6979_nonce_plain(*args), 20, 1,
                            rfc6979_blocks(extra, attempt) * SHA256_BLOCK_OPS
                            * lanes, (96 + 32 * extra) * lanes, lanes=lanes)


def chain_work(e, modulus, lanes):
    """(32-bit products, bytes) of x^e on `lanes` lanes by the chain
    kernel: each step's squarings and multiply; one read and one write a
    lane."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    sqr_c, mul_c = (SQR_P, MUL_P) if modulus == fe.P else (SQR_N, MUL_N)
    steps = K.pow_chain_steps(e)
    squarings = sum(k for _, k, _, _ in steps)
    multiplies = sum(mul != K.POW_ACC for _, _, mul, _ in steps)
    return (squarings * sqr_c + multiplies * mul_c) * lanes, 2 * 64 * lanes


def chain_checks(int_rate, res, rng, device):
    """The chain kernel against its plain version, bit-exact, and python
    ints on a few lanes: at LANES lanes for each of CHAIN_EXPONENTS, at one
    lane for n - 2 and p - 2 (the root of invert_batch), at a ragged width;
    the edge values in every batch of more than 7 lanes (lanes 0-6), and
    one-lane batches of 0, 1 and m - 1.  Each timed (profiler, cold L2)
    beside its bound and its plain version; the one-lane times give one
    thread's latency per step.  A constant-time witness: the one-lane n - 2
    chain's device time on 0, on m - 1 and on a random value."""
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    name = "mod_pow_chain"
    shapes = {}
    cases = [(label, lanes) for label in CHAIN_EXPONENTS
             for lanes in (LANES,)] + [("n-2", 1), ("p-2", 1),
                                       ("n-2", CHAIN_RAGGED)]
    for label, lanes in cases:
        e, modulus = CHAIN_EXPONENTS[label]
        x = random_planes(rng, max(lanes, 7), modulus, device)
        x = x[:, -lanes:].contiguous() if lanes == 1 else x
        got = K.mod_pow_chain(x, e, modulus)
        err = max_abs_err([got], [K.mod_pow_chain_plain(x, e, modulus)])
        n_int = min(lanes, 24)
        if lb.limbs_to_int_batch(got[:, :n_int]) != [
                pow(v, e, modulus)
                for v in lb.limbs_to_int_batch(x[:, :n_int])]:
            fail(f"mod_pow_chain {label} at {lanes} lanes: differs from "
                 f"python ints")
        products, nbytes = chain_work(e, modulus, lanes)
        steps = K.pow_chain_steps(e)
        tag = f"mod_pow_chain {label} at {lanes} lanes"
        ms = timed_check(int_rate, res, name, tag, err,
                         lambda: K.mod_pow_chain(x, e, modulus),
                         lambda: K.mod_pow_chain_plain(x, e, modulus), 10, 1,
                         products, nbytes, lanes=lanes)
        squarings = sum(k for _, k, _, _ in steps)
        multiplies = sum(mul != K.POW_ACC for _, _, mul, _ in steps)
        shapes[f"{label} at {lanes}"] = {
            "ms": ms, "bound_ms": bound_ms(int_rate, products, nbytes)[0],
            "steps": len(steps), "squarings": squarings,
            "multiplies": multiplies,
            "us_per_step": ms * 1e3 / (squarings + multiplies)}
        say(f"kernel {tag}: {len(steps)} steps, {squarings} squarings and "
            f"{multiplies} multiplies, {ms:.4f} ms device, "
            f"{ms * 1e3 / (squarings + multiplies):.4f} us a squaring or "
            f"multiply; python ints agree on {n_int} lanes")
    for label in ("n-2", "p-2"):
        e, modulus = CHAIN_EXPONENTS[label]
        for v in (0, 1, modulus - 1):
            x = torch.as_tensor(lb.int_to_limbs_batch([v]), dtype=torch.int32,
                                device=device)
            got = lb.limbs_to_int_batch(K.mod_pow_chain(x, e, modulus))
            if got != [pow(v, e, modulus)]:
                fail(f"mod_pow_chain {label}: {v} at one lane gives {got}")
    say("kernel mod_pow_chain: one-lane 0, 1 and m - 1 agree with python "
        "ints for n - 2 and p - 2 (invert(0) = 0)")
    e, modulus = CHAIN_EXPONENTS["n-2"]
    witness = {}
    for tag, v in (("zero", 0), ("m-1", modulus - 1),
                   ("random", int.from_bytes(rng.bytes(32), "big")
                    % modulus)):
        x = torch.as_tensor(lb.int_to_limbs_batch([v]), dtype=torch.int32,
                            device=device)
        witness[tag] = kernel_device_ms(
            lambda x=x: K.mod_pow_chain(x, e, modulus), 20,
            KERNEL_SYMBOL[name])[0]
    say("kernel mod_pow_chain n-2 at one lane, constant-time witness "
        "(device ms): " + ", ".join(f"{t} {ms:.4f}"
                                    for t, ms in witness.items()))
    res[name]["shapes"] = shapes
    res[name]["constant_time_ms"] = witness


def timed_check(int_rate, res, name, label, err, call, plain_call, reps,
                plain_reps, products_total, bytes_total, keep=True,
                mma_ops=0, lanes=None):
    """Fail unless err is 0, then time the kernel (profiler, cold L2), its
    wrapper and its plain version (CUDA events) and print them with the
    bound (mma_ops: int8 MMA operations beside the products).  keep:
    record these numbers as the kernel's row (else only the error
    counts).  Returns the kernel's device milliseconds."""
    if err != 0:
        fail(f"{label}: kernel differs from its plain version, max abs err "
             f"{err}")
    ms, seen = kernel_device_ms(call, reps, KERNEL_SYMBOL[name])
    wrapper_ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(plain_call, plain_reps,
                       warmup=1 if plain_reps > 1 else 0)
    b_ms, b_by = bound_ms(int_rate, products_total, bytes_total, mma_ops)
    say(f"kernel {label}: bit-exact at {lanes or LANES} lanes, {ms:.4f} ms "
        f"device "
        f"with a cold L2 (mean of {seen} of {reps} launches; wrapper call "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms), bound {b_ms:.4f} "
        f"ms by {b_by}")
    prev = res.get(name)
    if keep and prev is None:
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
    elif prev is not None:
        prev["max_abs_err"] = max(prev["max_abs_err"], err)
    return ms


def tiled_points(curve, rng, lanes, device, n_pts=64):
    """(affine python-int points, x plane, y plane): n_pts random multiples
    of G tiled over the lanes."""
    from secp256k1_tpu_torch.ops import limbs as lb
    hc = curve.hc
    pts = [curve.g_mul(int.from_bytes(rng.bytes(32), "big") % hc.N or 1)
           for _ in range(n_pts)]
    idx = torch.arange(lanes, device=device) % n_pts
    xs, ys = (torch.as_tensor(lb.int_to_limbs_batch([p[c] for p in pts]),
                              dtype=torch.int32, device=device)[:, idx]
              .contiguous() for c in range(2))
    return pts, xs, ys


def engine_kernel_checks(int_rate, curve, rng, device, res):
    """The kernels behind the engine switches at LANES lanes, each
    bit-exact against its plain version (edge values, digit 0 in window 0,
    all-zero and all-15 digit columns), a few lanes against python ints,
    timed beside the bound; #9 from lane tables and nibble digits, its
    affine result against #7's and #4's for the same scalars; the widened
    fixed-base kernels at their new shapes (#6 unsigned w = 8, signed w = 6
    and w = 12; #5 at w = 6 and 12)."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import glv
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.ops import scalar as sc
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    hc = curve.hc
    lanes = LANES
    lane_bytes = 16 * 4
    n_pts = 64
    pts, qx, qy = tiled_points(curve, rng, lanes, device, n_pts)

    def check(name, label, got, plain, call, plain_call, reps, plain_reps,
              products, nbytes, keep=True, mma_ops=0):
        timed_check(int_rate, res, name, label, max_abs_err(got, plain),
                    call, plain_call, reps, plain_reps, products, nbytes,
                    keep, mma_ops)

    # point_double4 and point_add_mixed on random-Z points: lanes 0-7
    # P == Q, 8-15 P == -Q, 16-19 P the identity (0, Z, 0).
    p1 = random_z(qx, qy, rng, device)
    perm = (torch.arange(lanes, device=device) * 7 + 3) % lanes
    ax, ay = qx[:, perm].contiguous(), qy[:, perm].contiguous()
    ax[:, :16] = qx[:, :16]
    ay[:, :16] = qy[:, :16]
    ay[:, 8:16] = fe.neg(qy[:, 8:16])
    p1[1][:, 16:20] = p1[2][:, 16:20]
    p1[0][:, 16:20] = 0
    p1[2][:, 16:20] = 0
    # The same 24 lanes again from SPLIT_LANE on, in another warp.
    for c in p1:
        c[:, SPLIT_LANE:SPLIT_LANE + 24] = c[:, :24]
    a = [None if 16 <= i < 20 else pts[i % n_pts] for i in range(24)]
    b = [pts[int(perm[i]) % n_pts] if i >= 16 else
         pts[i % n_pts] if i < 8 else hc.neg(pts[i % n_pts])
         for i in range(24)]
    got = K.point_double4(*p1)
    check("point_double4", "point_double4", got, K.point_double4_plain(*p1),
          lambda: K.point_double4(*p1), lambda: K.point_double4_plain(*p1),
          50, 3, 4 * PT_DOUBLE * lanes, 6 * lane_bytes * lanes)
    want16 = [hc.mul(16, x) if x else None for x in a]
    check_points(got, want16, hc, "point_double4")
    check_points([c[:, SPLIT_LANE:] for c in got], want16, hc,
                 f"point_double4 lanes {SPLIT_LANE}+")
    got = K.point_add_mixed(*p1, ax, ay)
    check("point_add_mixed", "point_add_mixed", got,
          K.point_add_mixed_plain(*p1, ax, ay),
          lambda: K.point_add_mixed(*p1, ax, ay),
          lambda: K.point_add_mixed_plain(*p1, ax, ay), 50, 3,
          PT_ADD_MIXED * lanes, 8 * lane_bytes * lanes)
    check_points(got, [hc.add(x, y) for x, y in zip(a, b)], hc,
                 "point_add_mixed")

    # point_lookup_add: accumulators p1, the lane tables of (ax, ay, 1).
    base = pt.Point(ax, ay, fe.one((lanes,), device))
    table = tbl.build_lane_table(base)
    digits = torch.as_tensor(rng.integers(0, 16, lanes), dtype=torch.int32,
                             device=device)
    digits[:16] = torch.arange(16, device=device)
    got = K.point_lookup_add(*p1, table, digits)
    check("point_lookup_add", "point_lookup_add", got,
          K.point_lookup_add_plain(*p1, table, digits),
          lambda: K.point_lookup_add(*p1, table, digits),
          lambda: K.point_lookup_add_plain(*p1, table, digits), 20, 2,
          PT_ADD * lanes, (15 * 48 * 4 + 6 * lane_bytes + 4) * lanes)
    check_points(got, [hc.add(x, hc.mul(int(d), y)) if d else x
                       for x, y, d in zip(a, b, digits[:24].tolist())], hc,
                 "point_lookup_add")

    # The GLV kernels on u2 * Q (Q affine), the operands of verify's GLV.
    q = pt.Point(qx, qy, fe.one((lanes,), device))
    u2 = random_planes(rng, lanes, sc.N, device)
    k1, k2, gp1, gp2 = glv._short_scalars(u2, q)
    gp1, gp2 = pt._planes(gp1), pt._planes(gp2)
    d1 = glv._nibble_digits_128(k1).contiguous()
    d2 = glv._nibble_digits_128(k2).contiguous()
    signed = K.glv_windowed_mult_signed_from_points(
        *glv.glv_kernel_operands(u2, q))
    # Edge digit columns: lane 24 all-zero d1, lane 25 all-zero d2, lane
    # 26 all-15 d1 and d2, lane 27 digit 0 in window 0 of both.
    d1[:, 24] = 0
    d2[:, 25] = 0
    d1[:, 26] = 15
    d2[:, 26] = 15
    d1[0, 27] = 0
    d2[0, 27] = 0
    # The same columns again in another warp (lanes 152-155), checked with
    # lanes SPLIT_LANE to SPLIT_LANE + 31 against python ints.
    for d in (d1, d2):
        d[:, SPLIT_LANE + 24:SPLIT_LANE + 28] = d[:, 24:28]
    edge = torch.zeros(lanes, dtype=torch.bool, device=device)
    edge[24:28] = True
    edge[SPLIT_LANE + 24:SPLIT_LANE + 28] = True
    name = "glv_windowed_mult_from_points"
    unsigned = K.glv_windowed_mult_from_points(d1, d2, gp1, gp2)
    nz = int((d2[0] != 0).sum()) + int((d1[1:] != 0).sum()) \
        + int((d2[1:] != 0).sum())
    check(name, "glv unsigned (#7)", unsigned,
          K.glv_windowed_mult_from_points_plain(d1, d2, gp1, gp2),
          lambda: K.glv_windowed_mult_from_points(d1, d2, gp1, gp2),
          lambda: K.glv_windowed_mult_from_points_plain(d1, d2, gp1, gp2),
          5, 1, (26 * lanes + nz) * PT_ADD
          + (2 * lanes + 4 * 31 * lanes) * PT_DOUBLE,
          (2 * 32 * 4 + 9 * lane_bytes) * lanes)

    def digit_ints(d, lo):
        vals = d[:, lo:lo + 32].t().tolist()
        return [sum(v << (4 * (31 - i)) for i, v in enumerate(col))
                for col in vals]

    for lo in (0, SPLIT_LANE):
        g1, g2 = affine_lanes(gp1, lo, 32, hc), affine_lanes(gp2, lo, 32, hc)
        check_points([c[:, lo:] for c in unsigned],
                     [hc.add(hc.mul(a1, x), hc.mul(a2, y))
                      for a1, a2, x, y in zip(digit_ints(d1, lo),
                                              digit_ints(d2, lo), g1, g2)],
                     hc, f"glv unsigned (#7) lanes {lo}-{lo + 31}")
    nibble_witness(res, name, "glv unsigned (#7)", d1, d2,
                   lambda w1, w2: K.glv_windowed_mult_from_points(
                       w1, w2, gp1, gp2))

    t1 = tbl.build_lane_table(pt.Point(*gp1))
    t2 = tbl.build_lane_table(pt.Point(*gp2))
    name = "glv_windowed_mult"
    tabled = K.glv_windowed_mult(d1, d2, t1, t2)
    check(name, "glv from lane tables (#9)", tabled,
          K.glv_windowed_mult_plain(d1, d2, t1, t2),
          lambda: K.glv_windowed_mult(d1, d2, t1, t2),
          lambda: K.glv_windowed_mult_plain(d1, d2, t1, t2), 5, 1,
          nz * PT_ADD + int((d1[0] != 0).sum()) * PT_ADD
          + 4 * 31 * lanes * PT_DOUBLE,
          (2 * 15 * 48 * 4 + 2 * 32 * 4 + 3 * lane_bytes) * lanes)
    nibble_witness(res, name, "glv from lane tables (#9)", d1, d2,
                   lambda w1, w2: K.glv_windowed_mult(w1, w2, t1, t2))
    aff7, aff9, aff4 = (pt.to_affine(pt.Point(*c))
                        for c in (unsigned, tabled, signed))
    same79 = all(torch.equal(x, y) for x, y in zip(aff7, aff9))
    same74 = all(torch.equal(x[:, ~edge], y[:, ~edge])
                 for x, y in zip(aff7, aff4))
    if not (same79 and same74):
        fail(f"glv: affine results differ (#7 vs #9 {same79}, #7 vs #4 "
             f"{same74})")
    say(f"kernel glv: #9's affine result equals #7's on all {lanes} lanes "
        f"and #4's on the {lanes - int(edge.sum())} lanes of unchanged "
        f"digits; projective X, Y, Z differ as the schedules do")

    # The fixed-base kernels at their other shapes, with the edge lanes.
    ks = random_planes(rng, lanes, sc.N, device)
    k_ints = lb.limbs_to_int_batch(ks[:, :16])
    want_kg = [curve.g_mul(v) for v in k_ints]
    for signed_digits, w in ((False, 8), (True, 6), (True, 12)):
        table = tbl.base_table(device, w, signed_digits)
        digits = (tbl._signed_digits(ks, w) if signed_digits
                  else tbl._raw_digits(ks, 8, 32).to(torch.int32))
        digits = digits.contiguous()
        edge_ks = base_edge_lanes(digits, w, table.shape[1], signed_digits)
        want_edge = [curve.g_mul(k) for k in edge_ks]
        label = f"base scan {'signed' if signed_digits else 'unsigned'} w={w}"
        got = K.base_windowed_add(digits, table, signed_digits)
        products, mma, nbytes = base_scan_work(
            int_rate, digits, table, signed_digits, label)
        check("base_windowed_add", label, got,
              K.base_windowed_add_plain(digits, table, signed_digits),
              lambda: K.base_windowed_add(digits, table, signed_digits),
              lambda: K.base_windowed_add_plain(digits, table,
                                                signed_digits),
              10, 1, products, nbytes, keep=False, mma_ops=mma)
        check_points(got, want_kg, hc, label)
        check_points([c[:, BASE_EDGE_LANE:] for c in got], want_edge, hc,
                     f"{label} edge lanes")
        if not signed_digits:
            continue
        label = f"base final w={w}"
        got = K.base_windowed_add_final(digits, table, *p1)
        check("base_windowed_add_final", label, got,
              K.base_windowed_add_final_plain(digits, table, *p1),
              lambda: K.base_windowed_add_final(digits, table, *p1),
              lambda: K.base_windowed_add_final_plain(digits, table, *p1),
              10, 1, products + lanes * PT_ADD,
              (digits.shape[0] * 4 + 6 * lane_bytes) * lanes
              + table.numel() * 2, keep=False)
        check_points(got, [hc.add(g, x) for g, x in zip(want_kg, a[:16])],
                     hc, label)
        q_edge = affine_lanes(p1, BASE_EDGE_LANE, len(edge_ks), hc)
        check_points([c[:, BASE_EDGE_LANE:] for c in got],
                     [hc.add(g, q) for g, q in zip(want_edge, q_edge)], hc,
                     f"{label} edge lanes")


def nibble_witness(res, name, label, d1, d2, call):
    """Constant-time witness of an unsigned GLV kernel, printed and not
    gated: its device time (cold L2) at all-zero digits, at 15 in every
    window and at the digits d1, d2."""
    witness = {}
    for tag, (w1, w2) in (("all-zero", (torch.zeros_like(d1),) * 2),
                          ("all-15", (torch.full_like(d1, 15),) * 2),
                          ("random", (d1, d2))):
        witness[tag] = kernel_device_ms(lambda w1=w1, w2=w2: call(w1, w2), 5,
                                        KERNEL_SYMBOL[name])[0]
    res[name]["constant_time_ms"] = witness
    spread = max(witness.values()) / min(witness.values()) - 1
    say(f"kernel {label} constant-time witness (device ms, cold L2): "
        + ", ".join(f"{t} {ms:.4f}" for t, ms in witness.items())
        + f"; spread {spread:.2%}")


class MsmPoints:
    """N_DISTINCT points a_i * G of known a_i, to tile over MSM lanes."""

    def __init__(self, curve, rng, device):
        from secp256k1_tpu_torch.ops import limbs as lb
        hc = curve.hc
        self.curve, self.device = curve, device
        self.logs = [int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1
                     for _ in range(N_DISTINCT)]
        pts = [curve.g_mul(a) for a in self.logs]
        self.x, self.y = (torch.as_tensor(
            lb.int_to_limbs_batch([q[c] for q in pts]), dtype=torch.int32,
            device=device) for c in range(2))

    def batch(self, n, rng):
        """(scalars [16, n], points (Z = 1), expected sum as an affine
        point): lane j holds a_(j mod 256) * G and a random k_j < 2^256 -
        2^240 (< n), so the sum is (sum_j k_j a_(j mod 256) mod n) * G,
        with the k_j summed by residue class limb by limb in numpy."""
        from secp256k1_tpu_torch.ops import field as fe
        from secp256k1_tpu_torch.ops import point as pt
        hc = self.curve.hc
        nd = len(self.logs)
        arr = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        arr[15] = np.minimum(arr[15], 0xFFFE)
        padded = np.pad(arr, ((0, 0), (0, (-n) % nd)))
        cls = padded.reshape(16, -1, nd).sum(1)           # [16, 256] < 2^63
        total = sum(a * sum(int(cls[limb, i]) << (16 * limb)
                            for limb in range(16))
                    for i, a in enumerate(self.logs)) % hc.N
        idx = torch.arange(n, device=self.device) % nd
        points = pt.Point(self.x[:, idx].contiguous(),
                          self.y[:, idx].contiguous(),
                          fe.one((n,), self.device))
        k = torch.as_tensor(arr, dtype=torch.int32, device=self.device)
        return k, points, self.curve.g_mul(total)


def msm_kernel_checks(int_rate, data, rng, device, res):
    """The bucket kernel against its plain version over every partial
    bucket: at MSM_CHECK_POINTS points (random Z) for unsigned w = 4 and
    signed w = 5 and 6, the first nb + 1 points of each window taking the
    digits 0 to nb (every bucket) and the next 64 magnitudes above nb (the
    kernel must discard them), some far above for w = 4; at a ragged N
    (MSM_CHECK_POINTS + 77, signed w = 5); with 3 slots (w = 4).  Then at
    MSM_POINTS (w = 4, the MSM path's digits [64, N]) its device time, the
    plain version's (one call), the two results against each other and the
    bound."""
    from secp256k1_tpu_torch.ops import msm
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    name = "msm_bucket_accumulate_all"
    m = msm.MSM_SLOTS
    err = 0

    def edge_digits(digits, nb, signed):
        nw = digits.shape[0]
        sign = torch.as_tensor(rng.integers(0, 2, (nw, 64 + nb + 1)) << 6,
                               dtype=torch.int32, device=device)
        digits[:, :nb + 1] = torch.arange(nb + 1, device=device)
        over = torch.as_tensor(rng.integers(nb + 1, 64, (nw, 64)),
                               dtype=torch.int32, device=device)
        digits[:, nb + 1:nb + 65] = over
        if signed:
            digits[:, :nb + 65] |= sign
        else:
            digits[:, nb + 65:nb + 69] = torch.as_tensor(
                [64, 65, 1 << 20, 2**31 - 1], dtype=torch.int32,
                device=device)
        return digits.contiguous()

    cases = [(4, MSM_CHECK_POINTS, m), (5, MSM_CHECK_POINTS, m),
             (6, MSM_CHECK_POINTS, m), (5, MSM_CHECK_POINTS + 77, m),
             (4, 600, 3)]
    for w, n, slots in cases:
        k, p, _ = data.batch(n, rng)
        p = random_z(p.x, p.y, rng, device)
        signed = w > 4
        nb = (1 << (w - 1)) if signed else (1 << w) - 1
        digits = edge_digits((msm._signed_digits(k, w) if signed
                              else msm._digits(k, w)).contiguous(), nb,
                             signed)
        got = K.msm_bucket_accumulate_all(digits, *p, nb, signed, slots)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(
            K.msm_bucket_accumulate_all_plain(digits, *p, nb, signed,
                                              slots)), 1, warmup=0)
        err = max(err, max_abs_err([got], plain))
        if err:
            fail(f"msm buckets w={w} at {n} points, {slots} slots: kernel "
                 f"differs from its plain version, max abs err {err}")
        say(f"kernel msm buckets w={w} ({'signed' if signed else 'unsigned'}"
            f", {nb} buckets, {digits.shape[0]} windows, {slots} slots): "
            f"bit-exact over all {got.shape[0] * nb * slots} partial buckets"
            f" at {n} points, every bucket hit, 64 magnitudes above {nb} a "
            f"window discarded; plain {plain_ms:.1f} ms")
    k, p, _ = data.batch(MSM_POINTS, rng)
    digits = msm._digits(k, 4).contiguous()
    n, nw, nb = MSM_POINTS, digits.shape[0], 15

    def call():
        return K.msm_bucket_accumulate_all(digits, *p, nb, False, m)
    ms, seen = kernel_device_ms(call, 3, KERNEL_SYMBOL[name])
    wrapper_ms = cuda_ms(call, 3)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(K.msm_bucket_accumulate_all_plain(
        digits, *p, nb, False, m)), 1, warmup=0)
    err = max(err, max_abs_err([call()], plain))
    if err:
        fail(f"msm buckets w=4 at {n} points: kernel differs from its plain "
             f"version, max abs err {err}")
    del plain
    adds = int(((digits >= 1) & (digits <= nb)).sum())
    b_ms, b_by = bound_ms(int_rate, adds * PT_ADD,
                          nw * n * 4 + 3 * 64 * n + nw * nb * 3 * 64 * m)
    say(f"kernel msm buckets w=4 at {n} points (the MSM path's shape): "
        f"bit-exact over all {nw * nb * m} partial buckets; {ms:.4f} ms "
        f"device with a cold L2 (mean of {seen} of 3 launches; wrapper call "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, one call), bound "
        f"{b_ms:.4f} ms by {b_by} ({adds} adds of nonzero digits)")
    res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by}
    fold_checks(int_rate, res, data, rng, device,
                msm._window_sums_fused(k, p, 4).contiguous())


def fold_rows(curve, rng, case, device):
    """(window sums int32 [W, 3, 16] with random Z, their affine points,
    window bits) of a fold edge case, least significant window first:
    "edge" (w = 4) B, B (equal consecutive sums), the identity (0, Z, 0),
    the identity (0, 1, 0), 16 A (equal to the accumulator at its add), A;
    "cancel" (w = 4) C, -16 A (the accumulator's negation at its add), A."""
    from secp256k1_tpu_torch.ops import limbs as lb
    hc = curve.hc

    def rand_point():
        return curve.g_mul(int.from_bytes(rng.bytes(32), "big") % (hc.N - 1)
                           + 1)
    a, b, c = rand_point(), rand_point(), rand_point()
    pts = [b, b, None, None, hc.mul(16, a), a] if case == "edge" \
        else [c, hc.neg(hc.mul(16, a)), a]
    zs = [int.from_bytes(rng.bytes(32), "big") % (hc.P - 1) + 1 for _ in pts]
    xyz = [(0, 1 if i == 3 else z, 0) if q is None
           else (q[0] * z % hc.P, q[1] * z % hc.P, z)
           for i, (q, z) in enumerate(zip(pts, zs))]
    rows = torch.as_tensor(lb.int_to_limbs_batch(
        [t[i] for t in xyz for i in range(3)]), dtype=torch.int32)
    rows = rows.t().reshape(len(pts), 3, 16).contiguous().to(device)
    return rows, pts, 4


def fold_checks(int_rate, res, data, rng, device, wsums):
    """The fold kernel against its plain version, projective X, Y, Z
    bit-exact: at the window sums of the 2^20-point bucket path (W = 64,
    w = 4; timed, the kernel's row), at the sort + scan path's (W = 32,
    w = 8, MSM_CHECK_POINTS points) and at the edge cases of `fold_rows`,
    whose results are also held against python ints.  The device time
    over the fold's point operations gives the latency of one (the fold
    is serial).""" 
    from secp256k1_tpu_torch.ops import msm
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    name = "msm_fold"
    hc = data.curve.hc
    k, p, _ = data.batch(MSM_CHECK_POINTS, rng)
    cases = [("bucket path", wsums, 4, None),
             ("sort + scan", msm.pippenger_window_sums(k, p, 8).contiguous(),
              8, None)]
    for case in ("edge", "cancel"):
        rows, pts, w = fold_rows(data.curve, rng, case, device)
        want = None
        for q in pts[::-1]:
            want = hc.add(hc.mul(1 << w, want) if want else None, q)
        cases.append((case, rows, w, want))
    for label, rows, w, want in cases:
        n_windows = rows.shape[0]
        got = K.msm_fold(rows, w)
        err = max_abs_err(got, K.msm_fold_plain(rows, w))
        ops = n_windows * (w + 1)
        tag = f"msm_fold {label} (W = {n_windows}, w = {w})"
        ms = timed_check(int_rate, res, name, tag, err,
                         lambda: K.msm_fold(rows, w),
                         lambda: K.msm_fold_plain(rows, w), 10, 1,
                         n_windows * (w * PT_DOUBLE + PT_ADD),
                         n_windows * 3 * 64 + 3 * 64, lanes=1)
        if want is not None:
            check_points(got, [want], hc, tag)
        res[name].setdefault("cases", {})[label] = {
            "windows": n_windows, "window_bits": w, "ms": ms,
            "us_per_point_op": ms * 1e3 / ops}
        say(f"kernel {tag}: {n_windows * w} doublings and {n_windows} adds "
            f"in turn in one warp, {ms * 1e3 / ops:.3f} us a point "
            f"operation")


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

def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@contextlib.contextmanager
def recording(names):
    """While open, every call of the kernel wrappers `names` keeps a copy
    of its arguments and results:
    {name: [(args, kwargs, results), ...]}."""
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    calls = {name: [] for name in names}
    wrappers = {name: getattr(K, name) for name in names}
    copies = {}

    def copy(a):
        # One copy of a tensor that several launches read (a lane table):
        # keyed by its storage, view and version, the original held so
        # that its memory is not reused while recording.
        if not isinstance(a, torch.Tensor):
            return a
        key = (a.data_ptr(), tuple(a.shape), a.stride(), a._version)
        if key not in copies:
            copies[key] = (a, a.clone())
        return copies[key][1]

    def keep(name):
        def call(*args, **kwargs):
            out = wrappers[name](*args, **kwargs)
            calls[name].append(([copy(a) for a in args], kwargs,
                                [o.clone() for o in as_tuple(out)]))
            return out
        return call
    for name in names:
        setattr(K, name, keep(name))
    try:
        yield calls
    finally:
        for name, fn in wrappers.items():
            setattr(K, name, fn)


def replay_plain(label, calls):
    """Each recorded launch of a path through its kernel's plain version,
    at the width the path gave it: bit-exact, or the run fails.  One line
    a path: each kernel's launches and operand widths."""
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    if not calls:
        return
    t0 = time.perf_counter()
    done = []
    for name, recs in calls.items():
        plain = getattr(K, f"{name}_plain")
        recs = [r for r in recs if r[0][0].shape[1]]     # skip empty batches
        if not recs:
            continue
        err = max(max_abs_err(outs, as_tuple(plain(*args, **kwargs)))
                  for args, kwargs, outs in recs)
        # lanes; the fold's [W, 3, 16] window sums: W
        widths = sorted({args[0].shape[0 if args[0].dim() == 3 else 1]
                         for args, _, _ in recs})
        if err:
            fail(f"path {label}: a launch of {name} differs from its plain "
                 f"version, max abs err {err}")
        span = f"{widths[0]}" if len(widths) == 1 \
            else f"{widths[0]}-{widths[-1]}, {len(widths)} distinct"
        done.append(f"{name} {len(recs)} (widths {span})")
    say(f"path {label}: every launch equals its plain version on its "
        f"operands ({time.perf_counter() - t0:.1f} s): {'; '.join(done)}")


def run_path(label, kernels, fn, replay=(), expect=None):
    """Drive one path: launch counts set to 0 just before fn(), read just
    after.  Fails if a kernel of the path was not launched, a plain version
    was called, a kernel of `expect` ({name: launches}) was launched
    another number of times, or one-lane point_add was launched where
    `expect` gives it 0 ("point_add at 1").  The launches of the kernels in
    `replay` are then held against their plain versions on the same
    operands."""
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    expect = {"mod_pow2k": 0, **(expect or {})}     # no path launches it
    with recording(replay) as calls:
        K.reset_counts()
        out = fn()
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    plain = dict(K.PLAIN_CALLS)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"path {label}: kernels not launched: {missing}")
    if any(plain.values()):
        fail(f"path {label}: plain versions called: {plain}")
    chains, one_lane = {}, {}
    for (name, width, detail), count in K.SHAPES.items():
        if name == "mod_pow_chain":
            tag = f"{CHAIN_LABEL.get(detail, hex(detail))} at {width}"
            chains[tag] = chains.get(tag, 0) + count
        elif width == 1 and detail is None:
            one_lane[name] = one_lane.get(name, 0) + count
    counts = dict(launches, **{f"{n} at 1": c for n, c in one_lane.items()})
    wrong = {k: counts.get(k, 0) for k, v in expect.items()
             if counts.get(k, 0) != v}
    if wrong:
        fail(f"path {label}: launches {wrong}, expected "
             f"{ {k: expect[k] for k in wrong} }")
    PATH_LAUNCHES[label] = launches
    CHAIN_SHAPES[label] = chains
    ONE_LANE[label] = one_lane
    say(f"path {label}: launches "
        f"{ {k: v for k, v in launches.items() if v} }; plain-version "
        f"calls 0; mod_pow_chain by exponent and width {chains}; one-lane "
        f"launches {one_lane}")
    replay_plain(label, calls)
    return out


def check_statuses(label, got, expected):
    if got.shape != expected.shape:
        fail(f"path {label}: status shape {got.shape}")
    bad = np.nonzero(got != expected)[0]
    if bad.size:
        fail(f"path {label}: {bad.size} lanes with a wrong status, first "
             f"{bad[:5].tolist()}: got {got[bad[:5]].tolist()}, expected "
             f"{expected[bad[:5]].tolist()}")
    counts = {int(c): int((expected == c).sum()) for c in np.unique(expected)}
    say(f"path {label}: every status as expected {counts}")


def main_path(triples, rng, hc, wide):
    from secp256k1_tpu_torch.models import ecdsa
    pubs, digests, sigs, lens, expected = build_batch(
        triples, LANES, wide, rng, hc)
    label = f"verify ({pubs.shape[1]}-byte keys)"
    got = run_path(label, VERIFY_KERNELS, lambda: ecdsa.verify_batch_arrays(
        pubs, digests, sigs, lens, reject_malleable=True),
        expect={"mod_pow_chain": 2})
    check_statuses(label, got, expected)
    return pubs, digests, sigs, lens, expected


# ---------------------------------------------------------------------------
# Phase 4: the signing paths.
# ---------------------------------------------------------------------------

def ints_of_rows(rows):
    return [int.from_bytes(r.tobytes(), "big") for r in rows]


def rows_of_ints(vals):
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(-1, 32)


def rfc6979_rows():
    import csv
    with open(os.path.join(TESTDATA, "secp256k1_rfc6979_sha256.csv")) as fh:
        return [(int(r[0]), hashlib.sha256(r[1].encode()).digest(), r[2])
                for r in csv.reader(fh) if r and not r[0].startswith("#")]


def bip340_rows():
    import csv
    with open(os.path.join(TESTDATA, "bip-0340-test-vectors.csv")) as fh:
        return list(csv.DictReader(fh))


class Signers:
    """N_DISTINCT seeded keys tiled over the lanes, the 20 RFC 6979 vector
    keys on lanes 0-19, and a distinct seeded digest per lane (the
    vectors' own on their lanes)."""

    def __init__(self, curve, rng):
        hc = curve.hc
        self.kat = rfc6979_rows()
        self.scalars = [int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1
                        for _ in range(N_DISTINCT)] + [d for d, _, _ in
                                                       self.kat]
        self.points = [curve.g_mul(d) for d in self.scalars]
        self.key_of = np.arange(LANES) % N_DISTINCT
        self.key_of[:len(self.kat)] = N_DISTINCT + np.arange(len(self.kat))
        self.priv = rows_of_ints(self.scalars)[self.key_of]
        self.digests = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
        for j, (_, digest, _) in enumerate(self.kat):
            self.digests[j] = np.frombuffer(digest, np.uint8)
        cmp_rows = np.stack([np.frombuffer(hc.encode_point(p, True), np.uint8)
                             for p in self.points])
        self.pubs = cmp_rows[self.key_of]


def python_sign(curve, d: int, digest: bytes):
    """RFC 6979 ECDSA with python ints: (r, s, recovery id), low s."""
    from secp256k1_tpu_torch.models.rfc6979 import DrbgRFC6979
    n = curve.hc.N
    e = int.from_bytes(digest, "big") % n
    k = int.from_bytes(DrbgRFC6979(d.to_bytes(32, "big"),
                                   e.to_bytes(32, "big")).read(32), "big")
    big_r = curve.g_mul(k)
    r = big_r[0] % n
    s = pow(k, n - 2, n) * (e + r * d) % n
    v = (big_r[1] & 1) | (2 if big_r[0] >= n else 0)
    if s > n // 2:
        s, v = n - s, v ^ 1
    return r, s, v


def der_rows(sigs):
    """[n, 64] r || s rows -> ([n, 72] zero-padded DER rows, lens [n])."""
    from secp256k1_tpu_torch.models import codecs
    out = np.zeros((sigs.shape[0], 72), np.uint8)
    lens = np.zeros((sigs.shape[0],), np.int32)
    for i, row in enumerate(sigs):
        der = codecs.build_asn1_signature(int.from_bytes(row[:32].tobytes(),
                                                         "big"),
                                          int.from_bytes(row[32:].tobytes(),
                                                         "big"))
        out[i, :len(der)] = np.frombuffer(der, np.uint8)
        lens[i] = len(der)
    return out, lens


def ecdsa_sign_path(curve, signers, rng):
    """ECDSA sign, the verify of its signatures, recover and keyed verify,
    on the same 65,536 lanes."""
    from secp256k1_tpu_torch.models import codecs, ecdsa, keys
    from secp256k1_tpu_torch.utils import errors as ec
    sigs, recid, status = run_path(
        "ECDSA sign", ECDSA_SIGN_KERNELS,
        lambda: ecdsa.sign_batch_arrays(signers.priv, signers.digests))
    check_statuses("ECDSA sign", status, np.zeros_like(status))
    for j, (_, _, want) in enumerate(signers.kat):
        r, s = ints_of_rows(sigs[j].reshape(2, 32))
        if codecs.build_asn1_signature(r, s).hex().upper() != want:
            fail(f"ECDSA sign: RFC 6979 vector {j + 1} differs")
    say(f"path ECDSA sign: the {len(signers.kat)} RFC 6979 vectors in the "
        f"batch are byte-exact")
    picks = rng.choice(np.arange(len(signers.kat), LANES), N_DISTINCT,
                       replace=False)
    for i in picks:
        want = python_sign(curve, signers.scalars[signers.key_of[i]],
                           signers.digests[i].tobytes())
        got = (*ints_of_rows(sigs[i].reshape(2, 32)), int(recid[i]))
        if got != want:
            fail(f"ECDSA sign: lane {i} differs from the python-int signer")
    say(f"path ECDSA sign: {len(picks)} lanes equal a python-int RFC 6979 "
        f"signer (r, s and recovery id)")

    ders, lens = der_rows(sigs)
    got = run_path("verify of the signatures", VERIFY_KERNELS,
                   lambda: ecdsa.verify_batch_arrays(
                       signers.pubs, signers.digests, ders, lens,
                       reject_malleable=True))
    check_statuses("verify of the signatures", got, np.zeros_like(got))

    triples = [(*ints_of_rows(sigs[i].reshape(2, 32)), int(recid[i]))
               for i in range(LANES)]
    digest_list = [d.tobytes() for d in signers.digests]
    recovered = run_path("recover", VERIFY_KERNELS,
                         lambda: ecdsa.recover_batch(digest_list, triples))
    want_keys = [keys.PublicKey(p) for p in signers.points]
    wrong = [i for i in range(LANES)
             if recovered[i] != want_keys[signers.key_of[i]]]
    if wrong:
        fail(f"recover: {len(wrong)} lanes did not give back their signer, "
             f"first {wrong[:5]}")
    say(f"path recover: recover_batch gave back the signer on all {LANES} "
        f"lanes")

    cache = ecdsa.PubkeyCache(signers.points)
    key_idx = signers.key_of.astype(np.int64)
    digests = signers.digests.copy()
    ders_k = ders.copy()
    expected = np.full((LANES,), ec.OK, np.int32)
    lanes = rng.permutation(np.arange(len(signers.kat), LANES))
    per_kind = LANES // 1024
    kinds = [lanes[i * per_kind:(i + 1) * per_kind] for i in range(4)]
    key_idx[kinds[0]] = cache.n_keys + kinds[0] % 7       # index past the end
    expected[kinds[0]] = ec.ERR_INVALID_PUBLIC_KEY
    key_idx[kinds[1]] = -1 - kinds[1] % 3                 # negative index
    expected[kinds[1]] = ec.ERR_INVALID_PUBLIC_KEY
    digests[kinds[2], 7] ^= 0x01                          # flipped digest bit
    expected[kinds[2]] = ec.ERR_V_NEQ_R
    ders_k[kinds[3], 0] = 0x31                            # malformed DER
    expected[kinds[3]] = ec.ERR_INVALID_ENCODING
    got = run_path("keyed verify", VERIFY_CORE_KERNELS,
                   lambda: ecdsa.verify_batch_arrays_keyed(
                       cache, key_idx, digests, ders_k, lens,
                       reject_malleable=True))
    check_statuses("keyed verify", got, expected)
    return sigs, recid, ders, lens, cache


def wallet_sign_path(signers, rng):
    """Bitcoin Core's wallet signer (`bitcoin.sign_der_batch_arrays`, low-R
    grinding) on the signers' LANES lanes with the native DRBG refusing
    every call: one DRBG launch a round (no lane resampled), every status
    OK; the RFC 6979 vectors' lanes and WALLET_SAMPLED_LANES others against
    the python-int reference signer `tests/wallet_sign_ref.py`."""
    from secp256k1_tpu_torch import native
    from secp256k1_tpu_torch.models import bitcoin
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import wallet_sign_ref as ref

    def refuse(*args, **kwargs):
        raise RuntimeError("the native DRBG was entered")
    saved = native.rfc6979_nonce_batch, native.rfc6979_continue
    native.rfc6979_nonce_batch = native.rfc6979_continue = refuse
    stats = bitcoin.SignStats()
    try:
        der, lens, status = run_path(
            "wallet sign", ECDSA_SIGN_KERNELS,
            lambda: bitcoin.sign_der_batch_arrays(
                signers.priv, signers.digests, stats=stats))
    finally:
        native.rfc6979_nonce_batch, native.rfc6979_continue = saved
    check_statuses("wallet sign", status, np.zeros_like(status))
    launches = PATH_LAUNCHES["wallet sign"]["rfc6979_nonce"]
    if launches != stats.rounds:
        fail(f"wallet sign: {launches} rfc6979_nonce launches over "
             f"{stats.rounds} rounds")
    picks = list(range(len(signers.kat))) + rng.choice(
        np.arange(len(signers.kat), LANES), WALLET_SAMPLED_LANES,
        replace=False).tolist()
    for i in picks:
        want = ref.core_sign(signers.scalars[signers.key_of[i]],
                             signers.digests[i].tobytes())[0]
        if der[i, :lens[i]].tobytes() != want:
            fail(f"wallet sign: lane {i} differs from the reference signer")
    say(f"path wallet sign: {stats.rounds} rounds, {stats.seedings} DRBG "
        f"seedings, {launches} rfc6979_nonce launches (one a round), the "
        f"native DRBG never entered; {len(picks)} lanes equal the python-int"
        f" reference signer")


def schnorr_path(curve, signers, rng):
    """BIP-0340 sign and verify on 65,536 lanes: vectors 0-3 signed in the
    batch, vectors 0-14 verified in it."""
    from secp256k1_tpu_torch.models import schnorr
    rows = bip340_rows()
    priv = signers.priv.copy()
    msgs = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
    aux = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
    x_only = np.stack([np.frombuffer(p[0].to_bytes(32, "big"), np.uint8)
                       for p in signers.points])
    pub_x = x_only[signers.key_of]
    signed = [r for r in rows if r["secret key"] and len(r["message"]) == 64]
    for j, r in enumerate(signed):
        priv[j] = np.frombuffer(bytes.fromhex(r["secret key"]), np.uint8)
        msgs[j] = np.frombuffer(bytes.fromhex(r["message"]), np.uint8)
        aux[j] = np.frombuffer(bytes.fromhex(r["aux_rand"]), np.uint8)
        pub_x[j] = np.frombuffer(bytes.fromhex(r["public key"]), np.uint8)
    sigs, status = run_path(
        "Schnorr sign", SIGN_KERNELS,
        lambda: schnorr.sign_batch_arrays(priv, msgs, aux))
    check_statuses("Schnorr sign", status, np.zeros_like(status))
    if PATH_LAUNCHES["Schnorr sign"]["base_windowed_add"] != 3:
        fail("Schnorr sign: expected 3 launches of base_windowed_add")
    for j, r in enumerate(signed):
        if sigs[j].tobytes().hex().upper() != r["signature"]:
            fail(f"Schnorr sign: BIP-0340 vector {r['index']} differs")
    say(f"path Schnorr sign: BIP-0340 vectors "
        f"{[r['index'] for r in signed]} in the batch are byte-exact")

    expected = np.ones((LANES,), bool)
    listed = [r for r in rows if len(r["message"]) == 64]
    for j, r in enumerate(listed):
        pub_x[j] = np.frombuffer(bytes.fromhex(r["public key"]), np.uint8)
        msgs[j] = np.frombuffer(bytes.fromhex(r["message"]), np.uint8)
        sigs[j] = np.frombuffer(bytes.fromhex(r["signature"]), np.uint8)
        expected[j] = r["verification result"] == "TRUE"
    got = run_path("Schnorr verify", VERIFY_KERNELS,
                   lambda: schnorr.verify_batch_arrays(pub_x, msgs, sigs))
    bad = np.nonzero(got != expected)[0]
    if bad.size:
        fail(f"Schnorr verify: {bad.size} lanes wrong, first "
             f"{bad[:5].tolist()}")
    say(f"path Schnorr verify: all {LANES} lanes as expected (BIP-0340 "
        f"vectors {listed[0]['index']}-{listed[-1]['index']} in the batch, "
        f"{int((~expected).sum())} of them false)")
    return priv, msgs, aux, pub_x, sigs


@contextlib.contextmanager
def switches(mega=True, mega_signed=True, base_signed=True, base_window=8):
    """The JAX package's engine switches, set in the port for the block and
    restored to their defaults after it."""
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    K.set_mega(mega)
    K.set_mega_signed(mega_signed)
    tbl.set_base_signed(base_signed)
    tbl.set_base_window(base_window)
    try:
        yield
    finally:
        K.set_mega(True)
        K.set_mega_signed(True)
        tbl.set_base_signed(True)
        tbl.set_base_window(8)


class EcdhBatch:
    """LANES lanes of (private key, compressed peer key): the signers' keys
    tiled over the lanes, each lane's peer the public key of the next key,
    and corrupted lanes: a bad prefix, an x with no square root, k = 0 and
    k >= n (LANES / 1024 lanes each).  Expected statuses; the shared x of
    N_DISTINCT sampled lanes from python ints."""

    def __init__(self, curve, signers, rng):
        from secp256k1_tpu_torch.utils import errors as ec
        hc = curve.hc
        n_keys = len(signers.scalars)
        self.priv = signers.priv.copy()
        peer_of = (signers.key_of + 1) % n_keys
        cmp_rows = np.stack([np.frombuffer(hc.encode_point(p, True),
                                           np.uint8)
                             for p in signers.points])
        self.pubs = cmp_rows[peer_of]
        self.status = np.full((LANES,), ec.OK, np.int32)
        picks = rng.permutation(np.arange(len(signers.kat), LANES))
        per_kind = max(2, LANES // 1024)
        kinds = [picks[i * per_kind:(i + 1) * per_kind] for i in range(5)]
        self.pubs[kinds[0], 0] = 0x05
        self.pubs[kinds[1], 1:] = np.frombuffer(
            non_residue_x(hc).to_bytes(32, "big"), np.uint8)
        self.priv[kinds[2]] = 0
        self.priv[kinds[3]] = np.frombuffer(hc.N.to_bytes(32, "big"),
                                            np.uint8)
        self.priv[kinds[4]] = 0xFF                  # k = 2^256 - 1 >= n
        self.status[kinds[0]] = ec.ERR_INVALID_PUBLIC_KEY
        self.status[kinds[1]] = ec.ERR_INVALID_PUBLIC_KEY
        for kind in kinds[2:]:
            self.status[kind] = ec.ERR_INVALID_SCALAR
        ok = np.nonzero(self.status == ec.OK)[0]
        self.sampled = rng.choice(ok, N_DISTINCT, replace=False)
        self.want = {int(i): curve.g_mul(
            signers.scalars[signers.key_of[i]]
            * signers.scalars[peer_of[i]] % hc.N)[0] for i in self.sampled}


def ecdh_paths(batch):
    """ecdh_batch_arrays on LANES lanes under each GLV engine: statuses,
    the sampled lanes against python ints, every lane against the default
    engine's bytes, and every launch of each path against its plain
    version."""
    from secp256k1_tpu_torch.models import ecdh
    from secp256k1_tpu_torch.utils import errors as ec
    default = None
    for tag, flags, kernels in ECDH_ENGINES:
        label = f"ECDH ({tag})"
        with switches(**flags):
            shared, status = run_path(
                label, kernels,
                lambda: ecdh.ecdh_batch_arrays(batch.priv, batch.pubs),
                replay=kernels)
        check_statuses(label, status, batch.status)
        if shared[batch.status != ec.OK].any():
            fail(f"path {label}: a failed lane is not zeroed")
        for i, x in batch.want.items():
            if int.from_bytes(shared[i].tobytes(), "big") != x:
                fail(f"path {label}: lane {i} differs from python ints")
        if default is None:
            default = shared
        elif not np.array_equal(shared, default):
            bad = np.nonzero((shared != default).any(1))[0]
            fail(f"path {label}: {bad.size} lanes differ from the default "
                 f"engine, first {bad[:5].tolist()}")
        say(f"path {label}: {len(batch.want)} sampled lanes equal python "
            f"ints; every lane equals the default engine's bytes")
    return default


def base_switch_paths(triples, signers, rng, hc, default_sigs):
    """verify_batch_arrays (corrupted lanes) and ECDSA sign_batch_arrays on
    LANES lanes under each fixed-base switch: every status as in the
    default paths, every signature equal to the default path's (RFC 6979
    is deterministic) and the RFC 6979 vectors byte-exact; every launch
    against its plain version."""
    from secp256k1_tpu_torch.models import ecdsa
    for tag, flags, verify_kernels, sign_kernels in BASE_SWITCHES:
        pubs, digests, sigs, lens, expected = build_batch(
            triples, LANES, False, rng, hc)
        label = f"verify ({tag})"
        with switches(**flags):
            got = run_path(label, verify_kernels,
                           lambda: ecdsa.verify_batch_arrays(
                               pubs, digests, sigs, lens,
                               reject_malleable=True),
                           replay=verify_kernels)
        check_statuses(label, got, expected)
        label = f"ECDSA sign ({tag})"
        with switches(**flags):
            out_sigs, recid, status = run_path(
                label, sign_kernels,
                lambda: ecdsa.sign_batch_arrays(signers.priv,
                                                signers.digests),
                replay=sign_kernels)
        check_statuses(label, status, np.zeros_like(status))
        if not np.array_equal(out_sigs, default_sigs[0]) \
                or not np.array_equal(recid, default_sigs[1]):
            fail(f"path {label}: signatures differ from the default path's")
        say(f"path {label}: all {LANES} signatures and recovery ids equal "
            f"the default path's (the {len(signers.kat)} RFC 6979 vectors "
            f"among them)")


def engine_throughput(batch, triples, sign_planes, device):
    """ECDH/s end to end and of _ecdh_e2e_core under each GLV engine;
    verify/s of _verify_impl and sign/s of _sign_e2e_core under each
    fixed-base switch (CUDA events, median of 7).  Returns the ECDH core's
    byte planes."""
    from secp256k1_tpu_torch.models import ecdh, ecdsa

    def rate(ms):
        return LANES / ms * 1e3
    planes = ecdh_core_planes(batch, device)
    for tag, flags, _ in ECDH_ENGINES:
        with switches(**flags):
            e2e = wall_ms(lambda: ecdh.ecdh_batch_arrays(batch.priv,
                                                         batch.pubs), 5)
            core = median_cuda_ms(lambda: ecdh._ecdh_e2e_core(*planes))
        say(f"throughput: ECDH ({tag}) ecdh_batch_arrays end to end "
            f"{e2e[0]:.1f} ms (median of 5, range {e2e[1]:.1f}-"
            f"{e2e[2]:.1f}) = {rate(e2e[0]):.1f} ECDH/s; _ecdh_e2e_core "
            f"{core[0]:.3f} ms (median of 7, range {core[1]:.3f}-"
            f"{core[2]:.3f}) = {rate(core[0]):.1f} ECDH/s")
    verify_planes = core_planes(triples, LANES, device)
    for tag, flags, _, _ in BASE_SWITCHES:
        with switches(**flags):
            ver = median_cuda_ms(lambda: ecdsa._verify_impl(*verify_planes))
            sig = median_cuda_ms(lambda: ecdsa._sign_e2e_core(*sign_planes))
        say(f"throughput: ({tag}) _verify_impl {ver[0]:.3f} ms (median of "
            f"7, range {ver[1]:.3f}-{ver[2]:.3f}) = {rate(ver[0]):.1f} "
            f"verify/s; _sign_e2e_core {sig[0]:.3f} ms (range {sig[1]:.3f}-"
            f"{sig[2]:.3f}) = {rate(sig[0]):.1f} sign/s")
    return planes


def ecdh_core_planes(batch, device):
    """(k bytes, want_odd, peer x bytes) planes of _ecdh_e2e_core."""
    from secp256k1_tpu_torch.utils import batching as bt
    want_odd = bt.scalar_plane(batch.pubs[:, 0] == 0x03, LANES, fill=False,
                               dtype=torch.bool, device=device)
    return (bt.byte_plane_np(batch.priv, LANES, device), want_odd,
            bt.byte_plane_np(batch.pubs[:, 1:], LANES, device))


def sign_core_planes(signers, device):
    """(key, reduced digest, no extra data, candidate 0): the arguments of
    _sign_e2e_core, which derives the nonces itself."""
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.utils import batching as bt
    e_arr = ecdsa._reduce_digest_np(signers.digests)
    return [bt.byte_plane_np(a, LANES, device)
            for a in (signers.priv, e_arr)] + [None, 0]


def recover_core_args(sigs, recid, digests, device):
    """(r bytes, recovery ids, e, r, s) of _recover_core."""
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import scalar as sc
    from secp256k1_tpu_torch.utils import batching as bt
    r_bytes = bt.byte_plane_np(sigs[:, :32], LANES, device)
    e, _ = sc.S.from_bytes_any(bt.byte_plane_np(digests, LANES, device))
    r = sc.S._bytes_to_limbs(r_bytes).to(lb.DTYPE)
    s = sc.S._bytes_to_limbs(bt.byte_plane_np(sigs[:, 32:], LANES,
                                              device)).to(lb.DTYPE)
    return r_bytes, torch.as_tensor(recid, device=device), e, r, s


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

    pubs, digests, sigs, lens = arrays[:4]
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
    return med[LANES]


def wall_ms(fn, reps: int):
    """(median, min, max) host milliseconds of fn() ending in a device
    synchronize, over reps calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def median_cuda_ms(fn, reps: int = 7):
    times = sorted(cuda_ms(fn, 1, warmup=0) for _ in range(reps))
    return times[len(times) // 2], times[0], times[-1]


def signing_throughput(signers, ecdsa_out, schnorr_out, device):
    """sign/s end to end with the host DRBG apart, the device sign core,
    recover/s, keyed verify/s, Schnorr sign/s and verify/s.  Returns the
    sign core's byte planes."""
    from secp256k1_tpu_torch import native
    from secp256k1_tpu_torch.models import ecdsa, schnorr
    sigs, recid, ders, lens, cache = ecdsa_out
    priv, digests = signers.priv, signers.digests

    def rate(ms):
        return LANES / ms * 1e3

    e_arr = ecdsa._reduce_digest_np(digests)
    drbg = wall_ms(lambda: native.rfc6979_nonce_batch(priv, e_arr), 3)
    sign = wall_ms(lambda: ecdsa.sign_batch_arrays(priv, digests), 3)
    planes = sign_core_planes(signers, device)
    core = median_cuda_ms(lambda: ecdsa._sign_e2e_core(*planes))
    say(f"throughput: ECDSA sign_batch_arrays end to end {sign[0]:.1f} ms "
        f"(median of 3, range {sign[1]:.1f}-{sign[2]:.1f}) at {LANES} "
        f"lanes = {rate(sign[0]):.1f} sign/s; _sign_e2e_core from byte "
        f"planes, the DRBG kernel included, {core[0]:.3f} ms (median of 7, "
        f"range {core[1]:.3f}-{core[2]:.3f}) = {rate(core[0]):.1f} sign/s; "
        f"the native host DRBG, off the path, {drbg[0]:.1f} ms (median of "
        f"3)")

    rec_args = recover_core_args(sigs, recid, digests, device)
    rec_core = median_cuda_ms(lambda: ecdsa._recover_core(*rec_args))
    triples = [(int.from_bytes(sigs[i, :32].tobytes(), "big"),
                int.from_bytes(sigs[i, 32:].tobytes(), "big"), int(recid[i]))
               for i in range(LANES)]
    digest_list = [d.tobytes() for d in digests]
    rec = wall_ms(lambda: ecdsa.recover_batch(digest_list, triples), 1)
    say(f"throughput: _recover_core from planes {rec_core[0]:.3f} ms "
        f"(median of 7, range {rec_core[1]:.3f}-{rec_core[2]:.3f}) = "
        f"{rate(rec_core[0]):.1f} recover/s; recover_batch end to end "
        f"(python ints in, PublicKey objects out) {rec[0]:.1f} ms = "
        f"{rate(rec[0]):.1f} recover/s")

    keyed = wall_ms(lambda: ecdsa.verify_batch_arrays_keyed(
        cache, signers.key_of, digests, ders, lens, reject_malleable=True), 5)
    say(f"throughput: verify_batch_arrays_keyed end to end {keyed[0]:.1f} ms"
        f" (median of 5, range {keyed[1]:.1f}-{keyed[2]:.1f}) = "
        f"{rate(keyed[0]):.1f} verify/s")

    s_priv, s_msgs, s_aux, s_pub_x, s_sigs = schnorr_out
    ssign = wall_ms(lambda: schnorr.sign_batch_arrays(s_priv, s_msgs, s_aux),
                    3)
    sver = wall_ms(lambda: schnorr.verify_batch_arrays(s_pub_x, s_msgs,
                                                       s_sigs), 5)

    def sign_host():
        # The host work of Schnorr sign_batch_arrays: three native tagged
        # hashes (aux, nonce, challenge), the last two reduced mod n.
        schnorr._tagged_hash_rows(schnorr.TAG_AUX, [s_aux], LANES)
        for tag, parts in ((schnorr.TAG_NONCE, [s_aux, s_pub_x, s_msgs]),
                           (schnorr.TAG_CHALLENGE,
                            [s_sigs[:, :32], s_pub_x, s_msgs])):
            ecdsa._reduce_digest_np(schnorr._tagged_hash_rows(tag, parts,
                                                              LANES))
    host = wall_ms(sign_host, 3)
    hver = wall_ms(lambda: schnorr._tagged_hash_rows(
        schnorr.TAG_CHALLENGE, [s_sigs[:, :32], s_pub_x, s_msgs], LANES), 3)
    say(f"throughput: Schnorr sign_batch_arrays end to end {ssign[0]:.1f} ms"
        f" (median of 3, range {ssign[1]:.1f}-{ssign[2]:.1f}) = "
        f"{rate(ssign[0]):.1f} sign/s, its host tagged hashes and digest "
        f"reductions alone {host[0]:.1f} ms; verify_batch_arrays "
        f"{sver[0]:.1f} ms (median of 5, range {sver[1]:.1f}-{sver[2]:.1f}) "
        f"= {rate(sver[0]):.1f} verify/s, its host tagged hash alone "
        f"{hver[0]:.1f} ms")
    return planes


def profile_core(label, fn, expect):
    """Device time by kernel name over one fn() call, and the idle share of
    that call: 1 - device busy time / the span from its first device
    activity's start to its last one's end.  Every kernel of `expect` must
    appear in the session's records."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    prof, wall = profiled(label, fn, expect)
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    spans = [ev.time_range for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    busy = sum(s.elapsed_us() for s in spans) / 1e3
    span = (max(s.end for s in spans) - min(s.start for s in spans)) / 1e3
    say(f"profile: {label} under the profiler: "
        f"{len(spans)} device activities, busy {busy:.3f} ms of a "
        f"{span:.3f} ms device span ({wall * 1e3:.3f} ms host wall): idle "
        f"share {1 - busy / span:.3f}")
    for dev_us, key, count in rows[:12]:
        say(f"profile:   {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:80]}")


# ---------------------------------------------------------------------------
# Phase 4-5: hash-to-curve, consensus verify and the verify service.
# ---------------------------------------------------------------------------

H2C_SUITES = {"RO": "secp256k1_XMD_SHA-256_SSWU_RO_.json",
              "NU": "secp256k1_XMD_SHA-256_SSWU_NU_.json"}
# A suite vector j sits at lanes j + H2C_VECTOR_STRIDE * t.
H2C_VECTOR_STRIDE = 20495
H2C_ORACLE_LANES = 256
EDGE_CPU_LANES = 1024   # the map's plain version runs on this many lanes
# u with u^2 = 1/11 = -1/Z, where the map's tv2 is 0 (JAX swu.py:50).
U_TV2_ZERO = 0x331716177EC001CF0B2A4B9BF5C63274440235BA3DC0AF713237EC866179D785
# The double root of the isogeny's x_den and triple root of its y_den.
X_ISO_POLE = 0x89291C84DE3E11F1041DA6957255EED5FC964A4DF050DF221D6AD4CE6AB9C5A5
SERVICE_LANES = 16384
SERVICE_KEYS = N_DISTINCT


class H2cOracle:
    """Hash-to-curve in python ints, RFC 9380's straightforward forms
    (expand_message_xmd 5.3.1, simplified SWU 6.6.2, the 3-isogeny of
    E.1), not the port's straight-line steps: the constants come from the
    port's `ops.swu`, which the RFC's tables fix."""

    def __init__(self, hc):
        from secp256k1_tpu_torch.ops import swu
        self.hc, self.k = hc, swu

    @staticmethod
    def expand(msg: bytes, dst: bytes, n_out: int) -> bytes:
        if len(dst) > 255:
            dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
        dp = dst + bytes([len(dst)])
        b0 = hashlib.sha256(bytes(64) + msg + n_out.to_bytes(2, "big")
                            + b"\x00" + dp).digest()
        out, prev = b"", bytes(32)
        for i in range(1, (n_out + 31) // 32 + 1):
            prev = hashlib.sha256(bytes(a ^ b for a, b in zip(b0, prev))
                                  + bytes([i]) + dp).digest()
            out += prev
        return out[:n_out]

    def inv0(self, x):
        return pow(x, self.hc.P - 2, self.hc.P)

    def sqrt(self, x):
        p = self.hc.P
        r = pow(x, (p + 1) // 4, p)
        return r if r * r % p == x % p else None

    def sswu(self, u):
        p, k = self.hc.P, self.k
        a, b, z = k.A_PRIME, k.B_PRIME, k.Z
        tv1 = self.inv0((z * z * pow(u, 4, p) + z * u * u) % p)
        x1 = (-b) * self.inv0(a) * (1 + tv1) % p
        if tv1 == 0:
            x1 = b * self.inv0(z * a) % p
        x2 = z * u * u * x1 % p
        y1 = self.sqrt((x1 ** 3 + a * x1 + b) % p)
        x, y = (x1, y1) if y1 is not None else (
            x2, self.sqrt((x2 ** 3 + a * x2 + b) % p))
        return x, (y if u % 2 == y % 2 else -y % p)

    def iso(self, x, y):
        p, k = self.hc.P, self.k
        x_den = (x * x + k.K21 * x + k.K20) % p
        y_den = (x ** 3 + k.K42 * x * x + k.K41 * x + k.K40) % p
        if x_den == 0 or y_den == 0:
            return None
        x_num = (k.K13 * x ** 3 + k.K12 * x * x + k.K11 * x + k.K10) % p
        y_num = (k.K33 * x ** 3 + k.K32 * x * x + k.K31 * x + k.K30) % p
        return (x_num * self.inv0(x_den) % p,
                y * y_num * self.inv0(y_den) % p)

    def map(self, uniform48: bytes):
        u = int.from_bytes(uniform48, "big") % self.hc.P
        return self.iso(*self.sswu(u))

    def point(self, msg: bytes, dst: bytes, ro: bool):
        if not ro:
            return self.map(self.expand(msg, dst, 48))
        uniform = self.expand(msg, dst, 96)
        return self.hc.add(self.map(uniform[:48]), self.map(uniform[48:]))


class H2cBatch:
    """LANES seeded 32-byte messages, and the list form with each suite's
    vector messages at known lanes."""

    def __init__(self, rng):
        self.msgs = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
        self.suites = {}
        for suite, fname in H2C_SUITES.items():
            with open(os.path.join(TESTDATA, fname)) as fh:
                data = json.load(fh)
            msg_list = [m.tobytes() for m in self.msgs]
            at = {}
            for j, v in enumerate(data["vectors"]):
                for lane in range(j, LANES, H2C_VECTOR_STRIDE):
                    msg_list[lane] = v["msg"].encode()
                    at[lane] = (int(v["P"]["x"], 16), int(v["P"]["y"], 16))
            self.suites[suite] = (data["dst"].encode(), msg_list, at)


def h2c_paths(batch, hc, rng):
    """hash_to_curve_batch and encode_to_curve_batch on LANES messages with
    the suite vectors planted (every vector lane its file's P, sampled
    lanes against python ints, no identity), then the arrays forms on the
    seeded messages (every lane equal to the list form's where the
    messages are the same), every launch of the arrays forms held against
    its plain version."""
    from secp256k1_tpu_torch.models import h2c
    oracle = H2cOracle(hc)
    forms = {"RO": (h2c.hash_to_curve_batch, h2c.hash_to_curve_batch_arrays,
                    H2C_RO_KERNELS),
             "NU": (h2c.encode_to_curve_batch,
                    h2c.encode_to_curve_batch_arrays, H2C_NU_KERNELS)}
    for suite, (listed, arrays, kernels) in forms.items():
        dst, msg_list, at = batch.suites[suite]
        label = f"hash-to-curve {suite} ({LANES} messages, list)"
        got = run_path(label, kernels, lambda: listed(msg_list, dst),
                       expect={"mod_pow_chain": 5})
        if any(g is None for g in got):
            fail(f"path {label}: an identity lane")
        wrong = [lane for lane, want in at.items() if got[lane] != want]
        if wrong:
            fail(f"path {label}: vector lanes {wrong[:5]} differ from the "
                 f"suite file's P")
        picks = rng.choice(np.setdiff1d(np.arange(LANES), list(at)),
                           H2C_ORACLE_LANES, replace=False)
        for i in picks:
            if got[i] != oracle.point(msg_list[i], dst, suite == "RO"):
                fail(f"path {label}: lane {i} differs from python ints")
        say(f"path {label}: the {len(at)} vector lanes equal the suite "
            f"file's P, {len(picks)} sampled lanes equal python ints, no "
            f"identity")
        label = f"hash-to-curve {suite} ({LANES} messages, arrays)"
        pts, ident = run_path(label, kernels,
                              lambda: arrays(batch.msgs, dst),
                              replay=kernels, expect={"mod_pow_chain": 5})
        if pts.shape != (LANES, 64) or ident.any():
            fail(f"path {label}: shape {pts.shape}, {int(ident.sum())} "
                 f"identity lanes")
        xs, ys = ints_of_rows(pts[:, :32]), ints_of_rows(pts[:, 32:])
        wrong = [i for i in range(LANES)
                 if i not in at and (xs[i], ys[i]) != got[i]]
        if wrong:
            fail(f"path {label}: {len(wrong)} lanes differ from the list "
                 f"form, first {wrong[:5]}")
        say(f"path {label}: all {LANES - len(at)} lanes of the same "
            f"messages equal the list form's points")


def h2c_edge_checks(hc, rng, device):
    """swu.set_uniform_bytes at LANES lanes with the map's edge strings
    planted (u = 0, u^2 = 1/11 where tv2 = 0, u = p - 1, strings >= p) and
    iso_map with x' at its pole (mask False, the identity after
    set_uniform_bytes' select): bit-exact against the plain version (the
    CPU, first EDGE_CPU_LANES lanes) and python ints."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.ops import swu
    from secp256k1_tpu_torch.utils import batching as bt
    oracle = H2cOracle(hc)
    p = hc.P
    edge = [0, p, U_TV2_ZERO, p - U_TV2_ZERO, p + U_TV2_ZERO, p - 1, 1,
            2 * p - 1, 2 ** 384 - 1, (2 ** 384 - 1) // p * p, 2 ** 256]
    edge += [p + int.from_bytes(rng.bytes(40), "big") for _ in range(5)]
    uniform = rng.integers(0, 256, (LANES, 48), dtype=np.uint8)
    lanes = list(range(len(edge))) + [SPLIT_LANE + i for i in range(len(edge))]
    for i, lane in enumerate(lanes):
        uniform[lane] = np.frombuffer(
            edge[i % len(edge)].to_bytes(48, "big"), np.uint8)
    got = swu.set_uniform_bytes(bt.byte_plane_np(uniform, LANES, device))
    torch.cuda.synchronize()
    plain = swu.set_uniform_bytes(bt.byte_plane_np(uniform[:EDGE_CPU_LANES],
                                                   EDGE_CPU_LANES, "cpu"))
    err = max_abs_err([c[:, :EDGE_CPU_LANES].cpu() for c in got], plain)
    if err:
        fail(f"h2c edge lanes: set_uniform_bytes differs from its plain "
             f"version, max abs err {err}")
    checked = lanes + rng.choice(np.arange(2 * SPLIT_LANE, LANES), 64,
                                 replace=False).tolist()
    host = [c.cpu().numpy() for c in got]
    for lane in checked:
        x, y, z = (lb.limbs_to_int(c[:, lane]) for c in host)
        want = oracle.map(uniform[lane].tobytes())
        if (None if z == 0 else (x * pow(z, p - 2, p) % p,
                                 y * pow(z, p - 2, p) % p)) != want:
            fail(f"h2c edge lanes: set_uniform_bytes lane {lane} differs "
                 f"from python ints")
    say(f"kernel h2c edge lanes: set_uniform_bytes at {LANES} lanes equals "
        f"its plain version on {EDGE_CPU_LANES} lanes and python ints on "
        f"{len(checked)} (u = 0, tv2 = 0, p - 1, strings >= p)")

    xs = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(LANES)]
    ys = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(LANES)]
    poles = [0, 1, SPLIT_LANE, LANES - 1]
    for lane in poles:
        xs[lane] = X_ISO_POLE
    xo, yo, ok = swu.iso_map(bt.plane(xs, LANES, device=device),
                             bt.plane(ys, LANES, device=device))
    torch.cuda.synchronize()
    px, py, pok = swu.iso_map(
        bt.plane(xs[:EDGE_CPU_LANES], EDGE_CPU_LANES, device="cpu"),
        bt.plane(ys[:EDGE_CPU_LANES], EDGE_CPU_LANES, device="cpu"))
    err = max_abs_err([xo[:, :EDGE_CPU_LANES].cpu(),
                       yo[:, :EDGE_CPU_LANES].cpu(),
                       ok[:EDGE_CPU_LANES].cpu().to(torch.int32)],
                      [px, py, pok.to(torch.int32)])
    if err:
        fail(f"h2c edge lanes: iso_map differs from its plain version, max "
             f"abs err {err}")
    ok_host = ok.cpu().numpy()
    if ok_host[poles].any() or int((~ok_host).sum()) != len(poles):
        fail(f"h2c edge lanes: iso_map's mask is False at "
             f"{np.nonzero(~ok_host)[0][:8].tolist()}, expected {poles}")
    xo_host, yo_host = xo.cpu().numpy(), yo.cpu().numpy()
    for lane in poles + list(range(2, 66)):
        want = oracle.iso(xs[lane], ys[lane])
        if want is not None and (lb.limbs_to_int(xo_host[:, lane]),
                                 lb.limbs_to_int(yo_host[:, lane])) != want:
            fail(f"h2c edge lanes: iso_map lane {lane} differs from python "
                 f"ints")
    # set_uniform_bytes' last step: the identity where the mask is False.
    q = pt.select(ok, pt.Point(xo, yo, fe.one((LANES,), device)),
                  pt.identity((LANES,), device))
    if not torch.equal(pt.is_identity(q), ~ok):
        fail("h2c edge lanes: the pole lanes do not map to the identity")
    say(f"kernel h2c edge lanes: iso_map's mask is False exactly at the "
        f"{len(poles)} lanes of x' = the isogeny's pole, which map to the "
        f"identity; equal to its plain version on {EDGE_CPU_LANES} lanes "
        f"and python ints on {len(poles) + 64}")


def consensus_path(arrays, rng, hc):
    """verify_asn1_batch_arrays on the verify batch with a sighash byte
    after every DER, and lanes corrupted: the BIP-0066 vectors that must
    fail, high s, a missing sighash byte.  Every status as expected."""
    from secp256k1_tpu_torch.models import bitcoin, codecs
    from secp256k1_tpu_torch.utils import errors as ec
    pubs, digests, der, der_lens, expected = arrays
    sigs = np.zeros((LANES, 80), np.uint8)
    sigs[:, :der.shape[1]] = der
    sigs[np.arange(LANES), der_lens] = rng.integers(0, 256, LANES)
    lens = der_lens + 1
    expected = expected.copy()
    with open(os.path.join(TESTDATA, "bip-0066-test-vectors.json")) as fh:
        bad_vectors = [bytes.fromhex(c["DER"]) + b"\x01" for c in
                       json.load(fh)["invalid"]["decode"]]
    picks = rng.permutation(np.nonzero(expected == ec.OK)[0])
    per_kind = max(2, LANES // 1024)
    bip = picks[:per_kind]
    for k, i in enumerate(bip):
        sig = bad_vectors[k % len(bad_vectors)]
        sigs[i] = 0
        sigs[i, :len(sig)] = np.frombuffer(sig, np.uint8)
        lens[i] = len(sig)
    expected[bip] = ec.ERR_INVALID_ENCODING
    for i in picks[per_kind:2 * per_kind]:            # high s
        r, s = codecs.parse_asn1_signature(der[i, :der_lens[i]].tobytes())
        sig = codecs.build_asn1_signature(r, hc.N - s) + b"\x01"
        sigs[i] = 0
        sigs[i, :len(sig)] = np.frombuffer(sig, np.uint8)
        lens[i] = len(sig)
    expected[picks[per_kind:2 * per_kind]] = ec.ERR_MALLEABLE
    gone = picks[2 * per_kind:3 * per_kind]           # no sighash byte
    sigs[gone, der_lens[gone]] = 0
    lens[gone] = der_lens[gone]
    expected[gone] = ec.ERR_INVALID_ENCODING
    label = "consensus verify (BIP-0066, low s)"
    got = run_path(label, VERIFY_KERNELS,
                   lambda: bitcoin.verify_asn1_batch_arrays(
                       pubs, digests, sigs, lens),
                   expect={"mod_pow_chain": 2})
    check_statuses(label, got, expected)
    return pubs, digests, sigs, lens


class ServiceRequests:
    """LANES requests signed by the SERVICE_KEYS seeded signing keys (the
    RFC 6979 vector keys left out): the ECDSA sign path's lanes, a wrong
    digest on LANES / 1024 of them and a flipped signature byte on as many.
    """

    def __init__(self, signers, ecdsa_out, rng):
        from secp256k1_tpu_torch.models import keys
        _, _, ders, lens, _ = ecdsa_out
        kat = len(signers.kat)
        lanes = np.arange(kat, LANES + kat)
        lanes[lanes >= LANES] -= LANES - kat           # kat .. 2 kat - 1
        pubs = [keys.PublicKey(pt) for pt in signers.points[:SERVICE_KEYS]]
        self.expected = np.ones((LANES,), bool)
        digests = signers.digests[lanes].copy()
        sigs = ders[lanes].copy()
        picks = rng.permutation(LANES)
        per_kind = max(2, LANES // 1024)
        digests[picks[:per_kind], 3] ^= 0x40
        flip = picks[per_kind:2 * per_kind]
        sigs[flip, lens[lanes[flip]] - 1] ^= 0x01      # the last byte of s
        self.expected[picks[:2 * per_kind]] = False
        self.reqs = [(pubs[signers.key_of[lane]], digests[i].tobytes(),
                      sigs[i, :lens[lane]].tobytes())
                     for i, lane in enumerate(lanes)]


@contextlib.contextmanager
def device_spans(names):
    """While open, each call of the ecdsa entry points `names` is timed on
    the device by CUDA events around it; yields the list of milliseconds."""
    from secp256k1_tpu_torch.models import ecdsa
    spans = []
    real = {name: getattr(ecdsa, name) for name in names}

    def timed(fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
            return out
        return call
    for name, fn in real.items():
        setattr(ecdsa, name, timed(fn))
    try:
        yield spans
    finally:
        for name, fn in real.items():
            setattr(ecdsa, name, fn)


def service_paths(requests, device):
    """LANES requests from two submitting threads into VerifyService
    (max_lanes SERVICE_LANES, on the card), then again with a key cache of
    SERVICE_KEYS: every future's bool as expected; requests/s, batches and
    the device-busy share of the wall time (CUDA events around each
    batch's verify call, summed, over the wall time)."""
    from secp256k1_tpu_torch.models import service

    def drive(svc, spans):
        futs = [None] * LANES

        def submit(lo):
            for i in range(lo, LANES, 2):
                futs[i] = svc.submit(*requests.reqs[i])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(lo,))
                   for lo in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        svc.flush()
        wall = time.perf_counter() - t0
        got = np.asarray([f.result(timeout=60) for f in futs])
        return got, wall, sum(spans)

    for tag, capacity, kernels, entry in (
            ("unkeyed", 0, VERIFY_KERNELS, "verify_batch_arrays"),
            (f"key cache of {SERVICE_KEYS}", SERVICE_KEYS,
             VERIFY_CORE_KERNELS, "verify_batch_arrays_keyed")):
        label = f"verify service ({tag})"
        svc = service.VerifyService(max_lanes=SERVICE_LANES,
                                    key_cache_capacity=capacity,
                                    device=device)
        try:
            with device_spans([entry]) as spans:
                got, wall, busy = run_path(label, kernels,
                                           lambda: drive(svc, spans))
            batches = svc.batches
        finally:
            svc.close()
        bad = np.nonzero(got != requests.expected)[0]
        if bad.size:
            fail(f"path {label}: {bad.size} futures wrong, first "
                 f"{bad[:5].tolist()}")
        if len(spans) != batches:
            fail(f"path {label}: {len(spans)} {entry} calls for {batches} "
                 f"batches")
        say(f"path {label}: every future as expected "
            f"({int((~requests.expected).sum())} false); {LANES} requests "
            f"from 2 threads in {wall * 1e3:.1f} ms = {LANES / wall:.1f} "
            f"requests/s, {batches} batches, device busy {busy:.1f} ms = "
            f"{busy / (wall * 1e3):.3f} of the wall time")


def slice_throughput(batch, consensus, arrays, device):
    """Hash-to-curve end to end (median of 5), its expand alone (median of
    5) and its device cores from byte planes (CUDA events, median of 7),
    with the launches a call makes by kernel; consensus verify end to end
    beside verify_batch_arrays (median of 5 each, in turns).  Returns the
    cores' byte planes."""
    from secp256k1_tpu_torch.models import bitcoin, ecdsa, h2c
    from secp256k1_tpu_torch.utils import batching as bt

    def rate(ms):
        return LANES / ms * 1e3
    planes = {}
    for suite, n_out, arrays_fn, core in (
            ("RO", 96, h2c.hash_to_curve_batch_arrays, h2c._ro_bytes_core),
            ("NU", 48, h2c.encode_to_curve_batch_arrays,
             h2c._nu_bytes_core)):
        dst = batch.suites[suite][0]
        e2e = wall_ms(lambda: arrays_fn(batch.msgs, dst), 5)
        expand = wall_ms(lambda: h2c.expand_message_xmd_batch(
            batch.msgs, dst, n_out), 5)
        uniform = h2c.expand_message_xmd_batch(batch.msgs, dst, n_out)
        planes[suite] = [bt.byte_plane_np(np.ascontiguousarray(
            uniform[:, lo:lo + 48]), LANES, device)
            for lo in range(0, n_out, 48)]
        med = median_cuda_ms(lambda: core(*planes[suite]))
        launches = PATH_LAUNCHES[
            f"hash-to-curve {suite} ({LANES} messages, arrays)"]
        say(f"throughput: hash-to-curve {suite} arrays end to end "
            f"{e2e[0]:.1f} ms (median of 5, range {e2e[1]:.1f}-{e2e[2]:.1f})"
            f" at {LANES} messages = {rate(e2e[0]):.1f} h2c/s; "
            f"expand_message_xmd_batch alone {expand[0]:.1f} ms (median of "
            f"5, range {expand[1]:.1f}-{expand[2]:.1f}); {core.__name__} "
            f"from byte planes {med[0]:.3f} ms (median of 7, range "
            f"{med[1]:.3f}-{med[2]:.3f}) = {rate(med[0]):.1f} h2c/s; "
            f"launches a call {({k: v for k, v in launches.items() if v})}")
    walls = {"verify_asn1_batch_arrays": [], "verify_batch_arrays": []}
    for _ in range(5):
        for name, fn in (("verify_asn1_batch_arrays",
                          lambda: bitcoin.verify_asn1_batch_arrays(
                              *consensus)),
                         ("verify_batch_arrays",
                          lambda: ecdsa.verify_batch_arrays(
                              *arrays[:4], reject_malleable=True))):
            walls[name].append(wall_ms(fn, 1)[0])
    med = {k: sorted(v)[2] for k, v in walls.items()}
    say(f"throughput: consensus verify_asn1_batch_arrays end to end "
        f"{med['verify_asn1_batch_arrays']:.1f} ms (median of 5, range "
        f"{min(walls['verify_asn1_batch_arrays']):.1f}-"
        f"{max(walls['verify_asn1_batch_arrays']):.1f}) = "
        f"{rate(med['verify_asn1_batch_arrays']):.1f} verify/s; "
        f"verify_batch_arrays in turns with it "
        f"{med['verify_batch_arrays']:.1f} ms (range "
        f"{min(walls['verify_batch_arrays']):.1f}-"
        f"{max(walls['verify_batch_arrays']):.1f})")
    return planes


# ---------------------------------------------------------------------------
# Phase 4-5: the MSM paths and their throughput.
# ---------------------------------------------------------------------------

def msm_paths(data, rng):
    """multi_scalar_mult on MSM_POINTS (the bucket path, w = 4, and a
    signed-window call, w = 5), the sort + scan path (w = 8) on
    MSM_CHECK_POINTS and Straus on MSM_STRAUS_POINTS, each against python
    ints, and every kernel launch of each path against its plain version
    on the operands the path gave it."""
    from secp256k1_tpu_torch.ops import msm
    hc = data.curve.hc
    k, p, want = data.batch(MSM_POINTS, rng)
    if not msm._fused_msm_ok(p, 4):
        fail(f"msm: {MSM_POINTS} points do not take the bucket path")
    for label, w in ((f"msm ({MSM_POINTS} points, w=4)", None),
                     (f"msm signed ({MSM_POINTS} points, w=5)", 5)):
        got = run_path(label, MSM_KERNELS,
                       lambda: msm.multi_scalar_mult(k, p, w),
                       replay=MSM_KERNELS,
                       expect={"msm_fold": 1, "point_double": 0,
                               "point_add at 1": 0})
        check_points(got, [want], hc, f"path {label}")
    k, p, want = data.batch(MSM_CHECK_POINTS, rng)
    label = f"msm sort+scan ({MSM_CHECK_POINTS} points, w=8)"
    got = run_path(label, SCAN_KERNELS,
                   lambda: msm.multi_scalar_mult(k, p, 8),
                   replay=SCAN_KERNELS,
                   expect={"msm_fold": 1, "point_double": 0})
    check_points(got, [want], hc, f"path {label}")
    k, p, want = data.batch(MSM_STRAUS_POINTS, rng)
    label = f"msm Straus ({MSM_STRAUS_POINTS} points)"
    got = run_path(label, POINT_KERNELS,
                   lambda: msm.multi_scalar_mult_straus(k, p),
                   replay=POINT_KERNELS)
    check_points(got, [want], hc, f"path {label}")


def msm_throughput(data, rng, bucket_ms):
    """MSM points/s at each of MSM_RATE_SIZES: the median of 5 single
    calls by CUDA events (the automatic window: the bucket path); and the
    bucket kernel's device time as a share of the MSM_POINTS call."""
    from secp256k1_tpu_torch.ops import msm
    hc = data.curve.hc
    for n in MSM_RATE_SIZES:
        k, p, want = data.batch(n, rng)
        check_points(msm.multi_scalar_mult(k, p), [want], hc,
                     f"msm at {n} points")
        med, lo, hi = median_cuda_ms(lambda: msm.multi_scalar_mult(k, p), 5)
        say(f"throughput: multi_scalar_mult at {n} points {med:.3f} ms "
            f"(median of 5, range {lo:.3f}-{hi:.3f}) = {n / med * 1e3:.1f} "
            f"points/s")
        if n == MSM_POINTS:
            say(f"throughput: the bucket kernel's {bucket_ms:.3f} ms device "
                f"time is {bucket_ms / med:.3f} of the {n}-point call; the "
                f"rest (digits, lane merge, weighted sums, window fold) "
                f"{med - bucket_ms:.3f} ms")
        del k, p
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6: sharding on torch.distributed, the new ring functions, profiling.
# ---------------------------------------------------------------------------

def sharded_verify_path(mesh, triples, device):
    """sharded_verify_fn on the 65,536-lane verify planes of phase 5, r
    changed on every 8th lane: every status, gathered, equal to
    _verify_impl's; then the two rates in turns.  Returns the shards."""
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.parallel import mesh as meshmod
    from secp256k1_tpu_torch.parallel import sharded
    planes = list(core_planes(triples, LANES, device))
    planes[3] = planes[3].clone()
    planes[3][0, ::8] ^= 1
    want = ecdsa._verify_impl(*planes).cpu().numpy()
    if (want[::8] == 0).any() or (np.delete(want, np.s_[::8]) != 0).any():
        fail("sharded verify: _verify_impl did not reject exactly the "
             "lanes with a changed r")
    verify = sharded.sharded_verify_fn(mesh)
    shards = meshmod.shard_batch(mesh, planes)
    label = f"sharded verify (world {mesh.size()}, {LANES} lanes)"
    got = run_path(label, VERIFY_CORE_KERNELS,
                   lambda: meshmod.gather_batch(mesh, verify(*shards)),
                   replay=VERIFY_CORE_KERNELS, expect={"mod_pow_chain": 1})
    check_statuses(label, got.cpu().numpy(), want)
    times = {"sharded_verify_fn": [], "_verify_impl": []}
    for _ in range(7):
        times["sharded_verify_fn"].append(cuda_ms(
            lambda: verify(*shards), 1, warmup=0))
        times["_verify_impl"].append(cuda_ms(
            lambda: ecdsa._verify_impl(*planes), 1, warmup=0))
    med = {k: sorted(v)[3] for k, v in times.items()}
    say(f"throughput ({smi('name,power.limit')}): sharded_verify_fn at "
        f"world {mesh.size()} {med['sharded_verify_fn']:.3f} ms = "
        f"{LANES / med['sharded_verify_fn'] * 1e3:.1f} verify/s; "
        f"_verify_impl in turns with it {med['_verify_impl']:.3f} ms = "
        f"{LANES / med['_verify_impl'] * 1e3:.1f} verify/s (medians of 7, "
        f"CUDA events)")
    return planes


def sharded_msm_paths(mesh, data, rng):
    """sharded_msm on MSM_POINTS points (w = 4, the bucket path) against
    python ints and, X, Y, Z, against multi_scalar_mult; the split form on
    SPLIT_SHARDS virtual shards (local_fn on each slice one after another,
    the window sums stacked, _tree_reduce, combine_windows) against python
    ints, every point_add launch of its lane merges and tree replayed; the
    split form composed against sharded_msm; then points/s and the
    stages' times."""
    from secp256k1_tpu_torch.ops import msm
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.parallel import mesh as meshmod
    from secp256k1_tpu_torch.parallel import sharded
    hc = data.curve.hc
    w = SHARD_WINDOW
    k, p, want = data.batch(MSM_POINTS, rng)
    k_sh, p_sh = meshmod.shard_batch(mesh, (k, p))
    label = f"sharded msm (world {mesh.size()}, {MSM_POINTS} points, w={w})"
    got = run_path(label, MSM_KERNELS,
                   lambda: sharded.sharded_msm(mesh, k_sh, p_sh, w),
                   replay=("point_add", "msm_fold"),
                   expect={"msm_fold": 1, "point_double": 0,
                           "point_add at 1": 0})
    check_points(got, [want], hc, f"path {label}")
    whole = msm.multi_scalar_mult(k, p, w)
    if not all(torch.equal(a, b) for a, b in zip(got, whole)):
        fail(f"path {label}: X, Y, Z differ from multi_scalar_mult's")
    say(f"path {label}: X, Y, Z equal multi_scalar_mult's")

    local_fn, combine_fn = sharded.sharded_msm_split(mesh, w)
    step = MSM_POINTS // SPLIT_SHARDS
    slices = [(k[:, i:i + step], pt.Point(*(c[:, i:i + step] for c in p)))
              for i in range(0, MSM_POINTS, step)]

    def split():
        wsums = torch.stack([local_fn(*sl) for sl in slices])
        return msm.combine_windows(sharded._tree_reduce(wsums), w)
    label = (f"split msm ({SPLIT_SHARDS} virtual shards of {step} points, "
             f"w={w})")
    got = run_path(label, MSM_KERNELS, split, replay=("point_add",),
                   expect={"msm_bucket_accumulate_all": SPLIT_SHARDS,
                           "msm_fold": 1, "point_double": 0,
                           "point_add at 1": 0})
    check_points(got, [want], hc, f"path {label}")
    composed = combine_fn(local_fn(k_sh, p_sh))
    if not all(torch.equal(a, b) for a, b in zip(composed,
                                                 sharded.sharded_msm(
                                                     mesh, k_sh, p_sh, w))):
        fail("split msm: combine_fn(local_fn(...)) differs from sharded_msm")
    say("path split msm: combine_fn(local_fn(...)) equals sharded_msm, "
        "X, Y, Z")

    med = {}
    for name, fn in (("sharded_msm", lambda: sharded.sharded_msm(
            mesh, k_sh, p_sh, w)),
            ("multi_scalar_mult", lambda: msm.multi_scalar_mult(k, p, w))):
        med[name] = median_cuda_ms(fn, 5)
    wsums = torch.stack([local_fn(*sl) for sl in slices])
    local_ms = median_cuda_ms(lambda: local_fn(*slices[0]), 5)
    tree_ms = median_cuda_ms(lambda: msm.combine_windows(
        sharded._tree_reduce(wsums), w), 5)
    gather_ms = median_cuda_ms(lambda: combine_fn(wsums[0]), 5)
    say(f"throughput ({smi('name,power.limit')}): sharded_msm at world "
        f"{mesh.size()}, {MSM_POINTS} points, w={w}: "
        f"{med['sharded_msm'][0]:.3f} ms (median of 5, range "
        f"{med['sharded_msm'][1]:.3f}-{med['sharded_msm'][2]:.3f}) = "
        f"{MSM_POINTS / med['sharded_msm'][0] * 1e3:.1f} points/s; "
        f"multi_scalar_mult {med['multi_scalar_mult'][0]:.3f} ms = "
        f"{MSM_POINTS / med['multi_scalar_mult'][0] * 1e3:.1f} points/s")
    say(f"throughput: split msm stages: local_fn on one {step}-point shard "
        f"{local_ms[0]:.3f} ms (median of 5); the {SPLIT_SHARDS}-shard tree "
        f"and window fold {tree_ms[0]:.3f} ms; combine_fn at world "
        f"{mesh.size()} (all-gather and fold) {gather_ms[0]:.3f} ms")


def ring_function_paths(rng, device):
    """pow_const (edge values of x in the first lanes; exponents small,
    the chains' own, random and one split into parts) against python ints
    on POW_CONST_CHECK_LANES lanes; product_lanes and sum_lanes against
    python ints over every lane; bytes_are_canonical at the edge values,
    every lane; all at LANES lanes, launches counted, the kernels'
    launches replayed."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import modring
    from secp256k1_tpu_torch.ops import scalar as sc
    for ring, m, mod in ((fe.F, P_FIELD, "p"), (sc.S, N_ORDER, "n")):
        x = random_planes(rng, LANES, m, device)
        cols = torch.arange(POW_CONST_CHECK_LANES, device=device)
        xs = lb.limbs_to_int_batch(x[:, cols])
        exps = {"1": 1, "3": 3, "65537": 65537, "m-2": m - 2,
                "random": int.from_bytes(rng.bytes(32), "big"),
                "alternating": int("10" * 128, 2)}
        if ring is fe.F:
            exps["(p-3)/4"] = (m - 3) // 4
        for tag, e in exps.items():
            parts = len(ring._exponent_parts(e))
            label = f"pow_const mod {mod} e={tag} ({parts} chains)"
            got = run_path(label, ("mod_pow_chain",),
                           lambda: ring.pow_const(x, e),
                           replay=("mod_pow_chain", "mod_mul"),
                           expect={"mod_pow_chain": parts,
                                   "mod_mul": parts - 1})
            if lb.limbs_to_int_batch(got[:, cols]) != [pow(v, e, m)
                                                       for v in xs]:
                fail(f"{label}: differs from python ints")
        vals = lb.limbs_to_int_batch(x)
        label = f"product_lanes mod {mod}"
        nonzero = torch.where(lb.is_zero(x).unsqueeze(0),
                              ring.one((LANES,), device), x)
        got = run_path(label, ("mod_mul",),
                       lambda: ring.product_lanes(nonzero),
                       replay=("mod_mul",),
                       expect={"mod_mul": (LANES - 1).bit_length()})
        want = 1
        for v in vals:
            want = want * (v or 1) % m
        label_sum = f"sum_lanes mod {mod}"
        got_sum = run_path(label_sum, (), lambda: ring.sum_lanes(x))
        if lb.limbs_to_int_batch(got) != [want] or \
                lb.limbs_to_int_batch(got_sum) != [sum(vals) % m]:
            fail(f"{label} or {label_sum}: differs from python ints")
        edge = [m - 1, m, m + 1, 2**256 - 1, 0, 1]
        ints = edge + [int.from_bytes(rng.bytes(32), "big")
                       for _ in range(LANES - len(edge))]
        rows = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in ints),
                             np.uint8).reshape(LANES, 32)
        byts = torch.as_tensor(np.ascontiguousarray(rows.T), device=device)
        label = f"bytes_are_canonical mod {mod}"
        got = run_path(label, (), lambda: ring.bytes_are_canonical(byts))
        if got.cpu().tolist() != [v < m for v in ints]:
            fail(f"{label}: differs from python ints")
    say(f"ring functions at {LANES} lanes: pow_const (chains split into "
        f"parts where the step list is too short), product_lanes, "
        f"sum_lanes and bytes_are_canonical equal python ints")
    # These checks draw from a generator of their own, so that the data of
    # every earlier path stays as it was.
    alias_rng = np.random.default_rng(SEED + 11)
    pow_const_alias_paths(alias_rng, device)
    lookup_all_check(alias_rng, device)


def pow_const_alias_paths(rng, device):
    """`field.pow_const` and `scalar.pow_const` (the module aliases) at
    exponents above m - 1 and past the chain kernel's step list, each
    reduced to e' = ((e - 1) mod (m - 1)) + 1 before its chains are built,
    on LANES random planes, edge values first: launches counted (the
    chains of each e printed) and replayed; each result against the plain
    ring's `pow_const` (plain PyTorch on the card) on every lane and
    against python `pow` on the first POW_CONST_EDGE_LANES lanes and
    POW_CONST_SAMPLED_LANES sampled ones."""
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import modring
    from secp256k1_tpu_torch.ops import scalar as sc
    for mod, module, ring, m in (("p", fe, fe.F, P_FIELD),
                                 ("n", sc, sc.S, N_ORDER)):
        plain = modring.ModRing(m, f"plain mod {mod}", plain=True)
        x = random_planes(rng, LANES, m, device)
        sampled = rng.choice(np.arange(POW_CONST_EDGE_LANES, LANES),
                             POW_CONST_SAMPLED_LANES, replace=False)
        cols = torch.as_tensor(np.concatenate(
            [np.arange(POW_CONST_EDGE_LANES), np.sort(sampled)]),
            device=device)
        xs = lb.limbs_to_int_batch(x[:, cols])
        exps = {"2^4096": 2**4096, "2^5000+1": 2**5000 + 1, "m-1": m - 1,
                "m": m, "2^512-1": 2**512 - 1}
        for tag, e in exps.items():
            parts = len(ring._exponent_parts(e))
            label = (f"{module.__name__.rsplit('.', 1)[-1]}.pow_const "
                     f"mod {mod} e={tag} ({parts} chains)")
            got = run_path(label, ("mod_pow_chain",),
                           lambda: module.pow_const(x, e),
                           replay=("mod_pow_chain", "mod_mul"),
                           expect={"mod_pow_chain": parts,
                                   "mod_mul": parts - 1})
            err = max_abs_err(got, plain.pow_const(x, e))
            if err:
                fail(f"{label}: differs from the plain ring's pow_const, "
                     f"max abs err {err}")
            if lb.limbs_to_int_batch(got[:, cols]) != [pow(v, e, m)
                                                       for v in xs]:
                fail(f"{label}: differs from python pow")
    say(f"field.pow_const and scalar.pow_const at e = 2^4096, 2^5000 + 1, "
        f"m - 1, m, 2^512 - 1 on {LANES} lanes equal the plain ring's on "
        f"every lane and python pow on {POW_CONST_EDGE_LANES} + "
        f"{POW_CONST_SAMPLED_LANES} lanes")


def lookup_all_check(rng, device):
    """`table.lookup_shared_affine_all` on the w = 8 signed G table
    [33, 128, 2, 16] at LANES lanes, digits 0, 1 and E planted on the
    first lanes of every window: against the port's per-window
    `lookup_shared_affine`, stacked, on every lane, and against python
    ints (digit d of window w selects d * 2^(8w) * G, 0 the zero row) on
    the planted and LOOKUP_SAMPLED_LANES sampled lanes.  Plain PyTorch:
    no kernel is launched."""
    from secp256k1_tpu_torch.ops import limbs as lb
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.utils import hostcurve as hc
    table = tbl.base_table(device, 8, signed=True)
    n_windows, n_entries = table.shape[0], table.shape[1]
    digits = rng.integers(0, n_entries + 1, (n_windows, LANES))
    digits[:, :3] = [0, 1, n_entries]
    d = torch.as_tensor(digits, dtype=torch.int32, device=device)
    label = "table.lookup_shared_affine_all"
    sel = run_path(label, (), lambda: tbl.lookup_shared_affine_all(table, d))
    if any(s.shape != (n_windows, 16, LANES) for s in sel):
        fail(f"{label}: shapes {[tuple(s.shape) for s in sel]}")
    stacked = [tbl.lookup_shared_affine(table[k], d[k])
               for k in range(n_windows)]
    for c in range(2):
        err = max_abs_err(sel[c], torch.stack([s[c] for s in stacked]))
        if err:
            fail(f"{label}: differs from lookup_shared_affine by window, "
                 f"max abs err {err}")
    lanes = [0, 1, 2] + sorted(rng.choice(np.arange(3, LANES),
                                          LOOKUP_SAMPLED_LANES,
                                          replace=False).tolist())
    got_x = sel[0][:, :, lanes].cpu()
    got_y = sel[1][:, :, lanes].cpu()
    for k in range(n_windows):
        xs = lb.limbs_to_int_batch(got_x[k])
        ys = lb.limbs_to_int_batch(got_y[k])
        for j, lane in enumerate(lanes):
            v = int(digits[k, lane])
            want = (0, 0) if v == 0 else hc.mul(v << (8 * k), hc.G)
            if (xs[j], ys[j]) != want:
                fail(f"{label}: window {k} lane {lane} (digit {v}) differs "
                     f"from python ints")
    all_ms = median_cuda_ms(lambda: tbl.lookup_shared_affine_all(table, d),
                            3)
    say(f"{label} at {LANES} lanes on the [{n_windows}, {n_entries}, 2, 16] "
        f"signed table: equal to lookup_shared_affine by window on every "
        f"lane and to python ints on {len(lanes)} lanes; {all_ms[0]:.3f} ms "
        f"(median of 3, CUDA events)")


def trace_entry():
    """`--trace-entry`: one `profiling.trace` of the package's flagship step
    (`entry()`, _verify_core at 1,024 lanes) in a fresh process (late in a
    run the profiler lost the chain kernel of every such session, as it
    lost the MSM's bucket kernel: see PROFILE_PAD_S); its Chrome trace
    must name the verify kernels.  The kernels are already built."""
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    import_port()
    from secp256k1_tpu_torch import entry
    from secp256k1_tpu_torch.utils import profiling
    fn, args = entry.entry()
    fn(*args)
    torch.cuda.synchronize()
    want = [KERNEL_SYMBOL[name] for name in VERIFY_CORE_KERNELS]
    for _ in range(PROFILE_ATTEMPTS):
        with profiling.trace() as log_dir:
            time.sleep(PROFILE_PAD_S)
            fn(*args)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        path = os.path.join(log_dir, profiling.TRACE_FILE)
        with open(path) as fh:
            names = {ev.get("name", "") for ev in json.load(fh)["traceEvents"]}
        missing = [k for k in want if not any(k in n for n in names)]
        if not missing:
            break
        say(f"profile: trace lost {missing}; tracing again")
    else:
        fail(f"profiling.trace: no record of {missing} in {path}")
    say(f"profiling.trace of entry() (_verify_core at {args[0].shape[1]} "
        f"lanes, a process of its own): {path} ({os.path.getsize(path)} "
        f"bytes) names {want}")


def profiling_checks(res, verify_ms, planes):
    """`trace_entry` in a child process; `timed_chain` of _verify_impl
    beside phase 5's median; `roofline_report` of the point_add time of
    phase 3 beside its row."""
    from secp256k1_tpu_torch.models import ecdsa
    from secp256k1_tpu_torch.utils import profiling
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--trace-entry"], cwd=HERE, timeout=600)
    if child.returncode:
        fail(f"the tracing process exited {child.returncode}")
    per_call = profiling.timed_chain(ecdsa._verify_impl, tuple(planes))
    say(f"throughput ({smi('name,power.limit')}): timed_chain of "
        f"_verify_impl at {LANES} lanes {per_call * 1e3:.3f} ms a call "
        f"(slope of 1 and 4 calls, best of 3); phase 5's median "
        f"{verify_ms:.3f} ms")
    rep = profiling.roofline_report(LANES, res["point_add"]["ms"] / 1e3)
    if abs(rep["bound_s"] * 1e3 - res["point_add"]["bound_ms"]) > 1e-12:
        fail(f"roofline_report's bound {rep['bound_s'] * 1e3} ms is not "
             f"point_add's row {res['point_add']['bound_ms']} ms")
    say(f"profiling.roofline_report point_add at {LANES} lanes: "
        f"{json.dumps(rep)}; the kernel row's bound "
        f"{res['point_add']['bound_ms']:.4f} ms by "
        f"{res['point_add']['bound_by']}")


def sharding_phase(triples, data, res, verify_ms, device):
    """Phase 6: a process group of one rank (NCCL on the card: one card
    hosts one NCCL rank), the sharded paths, the new ring functions and
    the profiling helpers; the group is destroyed at the end, failed or
    not."""
    import torch.distributed as dist
    from secp256k1_tpu_torch.entry import free_port
    from secp256k1_tpu_torch.parallel import mesh as meshmod
    rng = np.random.default_rng(SEED + 10)
    meshmod.init_distributed(device=device,
                             init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        mesh = meshmod.data_mesh()
        say(f"sharding: world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, mesh {mesh}")
        meshmod.barrier("sharding phase", timeout_s=60)
        planes = sharded_verify_path(mesh, triples, device)
        sharded_msm_paths(mesh, data, rng)
        ring_function_paths(rng, device)
        profiling_checks(res, verify_ms, planes)
    finally:
        dist.destroy_process_group()


def profile_sign():
    """`--profile-sign`: one profiled `_sign_e2e_core` at LANES lanes of
    seeded keys and digests, in a fresh process (see PROFILE_PAD_S); the
    kernels are already built."""
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    import_port()
    from secp256k1_tpu_torch.models import ecdsa
    rng = np.random.default_rng(DRBG_SEED)
    priv = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
    priv[:, 0] &= 0x7F
    digests = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
    planes = sign_core_planes(types.SimpleNamespace(priv=priv,
                                                    digests=digests),
                              torch.device("cuda"))
    profile_core(f"_sign_e2e_core at {LANES} lanes (a process of its own)",
                 lambda: ecdsa._sign_e2e_core(*planes),
                 [KERNEL_SYMBOL[name] for name in ECDSA_SIGN_KERNELS])


def profile_msm():
    """`--profile-msm`: one profiled multi_scalar_mult at MSM_POINTS, in a
    fresh process (see PROFILE_PAD_S); the kernels are already built."""
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    import_port()
    from secp256k1_tpu_torch.ops import msm
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    k, p, _ = MsmPoints(HostCurve(), rng, device).batch(MSM_POINTS, rng)
    profile_core(f"multi_scalar_mult at {MSM_POINTS} points (a process of "
                 f"its own)", lambda: msm.multi_scalar_mult(k, p),
                 [KERNEL_SYMBOL[name] for name in MSM_KERNELS])


def cores_only():
    """`--cores`: the device cores of phase 5 alone (`_verify_impl`,
    `_sign_e2e_core`, `_recover_core`, `_ecdh_e2e_core` under each GLV
    engine), each the median of 7 single calls by CUDA events, in
    CORE_ROUNDS rounds; no checks past the signatures' statuses and no
    `ok` line.  For an A/B of two checkouts in one call: copy this script
    into each and run them in turn (parent, change, change, parent)."""
    phase_device()
    import_port()
    phase_build()
    from secp256k1_tpu_torch.models import ecdh, ecdsa
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    curve = HostCurve()
    triples = make_triples(curve, rng)
    signers = Signers(curve, rng)
    sigs, recid, status = ecdsa.sign_batch_arrays(signers.priv,
                                                  signers.digests)
    check_statuses("ECDSA sign", status, np.zeros_like(status))
    cores = [("_verify_impl", ecdsa._verify_impl,
              core_planes(triples, LANES, device), {}),
             ("_sign_e2e_core", ecdsa._sign_e2e_core,
              sign_core_planes(signers, device), {}),
             ("_recover_core", ecdsa._recover_core,
              recover_core_args(sigs, recid, signers.digests, device), {})]
    planes = ecdh_core_planes(EcdhBatch(curve, signers, rng), device)
    cores += [(f"_ecdh_e2e_core ({tag})", ecdh._ecdh_e2e_core, planes, flags)
              for tag, flags, _ in ECDH_ENGINES]
    times = {label: [] for label, *_ in cores}
    for _ in range(CORE_ROUNDS):
        for label, fn, args, flags in cores:
            with switches(**flags):
                times[label].append(median_cuda_ms(lambda: fn(*args))[0])
    for label, t in times.items():
        say(f"cores: {label} {sorted(t)[len(t) // 2]:.3f} ms at {LANES} "
            f"lanes (median of {len(t)} rounds, each the median of 7 calls:"
            f" {', '.join(f'{x:.3f}' for x in t)})")


def glv_only():
    """`--glv`: the three GLV kernels alone (#4, #7 and #9 on verify's GLV
    operands at LANES lanes): each one's device time with a cold L2 (the
    profiler, mean of 5 launches) and warm (CUDA events, median of 7
    single launches), in GLV_ROUNDS rounds; #9's result against its plain
    version.  No `ok` line.  For an A/B of two checkouts in one call, as
    `--cores`."""
    phase_device()
    import_port()
    phase_build()
    from secp256k1_tpu_torch.ops import field as fe
    from secp256k1_tpu_torch.ops import glv
    from secp256k1_tpu_torch.ops import point as pt
    from secp256k1_tpu_torch.ops import scalar as sc
    from secp256k1_tpu_torch.ops import table as tbl
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    _, qx, qy = tiled_points(HostCurve(), rng, LANES, device)
    q = pt.Point(qx, qy, fe.one((LANES,), device))
    u2 = random_planes(rng, LANES, sc.N, device)
    k1, k2, gp1, gp2 = glv._short_scalars(u2, q)
    gp1, gp2 = pt._planes(gp1), pt._planes(gp2)
    d1 = glv._nibble_digits_128(k1).contiguous()
    d2 = glv._nibble_digits_128(k2).contiguous()
    t1 = tbl.build_lane_table(pt.Point(*gp1))
    t2 = tbl.build_lane_table(pt.Point(*gp2))
    signed_ops = glv.glv_kernel_operands(u2, q)
    calls = {
        "glv_windowed_mult_signed_from_points":
            lambda: K.glv_windowed_mult_signed_from_points(*signed_ops),
        "glv_windowed_mult_from_points":
            lambda: K.glv_windowed_mult_from_points(d1, d2, gp1, gp2),
        "glv_windowed_mult": lambda: K.glv_windowed_mult(d1, d2, t1, t2)}
    err = max_abs_err(calls["glv_windowed_mult"](),
                      K.glv_windowed_mult_plain(d1, d2, t1, t2))
    if err:
        fail(f"glv_windowed_mult differs from its plain version, max abs "
             f"err {err}")
    times = {name: ([], []) for name in calls}
    for _ in range(GLV_ROUNDS):
        for name, fn in calls.items():
            times[name][0].append(kernel_device_ms(fn, 5,
                                                   KERNEL_SYMBOL[name])[0])
            times[name][1].append(median_cuda_ms(fn)[0])
    for name, (cold, warm) in times.items():
        say(f"glv: {name} ({KERNEL_SYMBOL[name]}) at {LANES} lanes: cold L2 "
            f"{sorted(cold)[len(cold) // 2]:.4f} ms, warm "
            f"{sorted(warm)[len(warm) // 2]:.4f} ms (medians of "
            f"{GLV_ROUNDS} rounds: cold "
            f"{', '.join(f'{x:.4f}' for x in cold)}; warm "
            f"{', '.join(f'{x:.4f}' for x in warm)})")


def main():
    if "--profile-msm" in sys.argv[1:]:
        return profile_msm()
    if "--profile-sign" in sys.argv[1:]:
        return profile_sign()
    if "--trace-entry" in sys.argv[1:]:
        return trace_entry()
    if "--cores" in sys.argv[1:]:
        return cores_only()
    if "--glv" in sys.argv[1:]:
        return glv_only()
    t_start = time.perf_counter()
    marks = [t_start]

    def phase(label):
        now = time.perf_counter()
        say(f"phase {label}: {now - marks[-1]:.1f} s")
        marks.append(now)
    int_rate = phase_device()
    import_port()
    phase_build()
    phase("device and build")
    from secp256k1_tpu_torch.ops.cuda import kernels as K
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    curve = HostCurve()
    res = kernel_checks(int_rate, curve, rng, device)
    drbg_checks(int_rate, res, device)
    phase("kernels")
    engine_kernel_checks(int_rate, curve, rng, device, res)
    phase("engine kernels")
    msm_data = MsmPoints(curve, rng, device)
    msm_kernel_checks(int_rate, msm_data, rng, device, res)
    phase("bucket kernel")

    t0 = time.perf_counter()
    triples = make_triples(curve, rng)
    signers = Signers(curve, rng)
    say(f"paths: {len(triples)} distinct signatures and "
        f"{len(signers.scalars)} signing keys made in "
        f"{time.perf_counter() - t0:.1f} s")
    arrays = main_path(triples, rng, curve.hc, wide=False)
    main_path(triples, rng, curve.hc, wide=True)
    ecdsa_out = ecdsa_sign_path(curve, signers, rng)
    wallet_sign_path(signers, np.random.default_rng(DRBG_SEED))
    schnorr_out = schnorr_path(curve, signers, rng)
    phase("signature paths")
    ecdh_batch = EcdhBatch(curve, signers, rng)
    ecdh_paths(ecdh_batch)
    phase("ECDH paths")
    base_switch_paths(triples, signers, rng, curve.hc, ecdsa_out[:2])
    phase("fixed-base switch paths")
    msm_paths(msm_data, rng)
    phase("MSM paths")
    # The slice's paths draw from a generator of their own, so that the
    # data of every earlier path stays as it was.
    slice_rng = np.random.default_rng(SEED + 9)
    h2c_batch = H2cBatch(slice_rng)
    h2c_paths(h2c_batch, curve.hc, slice_rng)
    h2c_edge_checks(curve.hc, slice_rng, device)
    consensus = consensus_path(arrays, slice_rng, curve.hc)
    service_paths(ServiceRequests(signers, ecdsa_out, slice_rng), device)
    phase("hash-to-curve, consensus and service paths")
    verify_ms = throughput(triples, arrays, device)
    sign_planes = signing_throughput(signers, ecdsa_out, schnorr_out, device)
    msm_throughput(msm_data, rng, res["msm_bucket_accumulate_all"]["ms"])
    ecdh_planes = engine_throughput(ecdh_batch, triples, sign_planes, device)
    h2c_planes = slice_throughput(h2c_batch, consensus, arrays, device)
    phase("throughput")
    sharding_phase(triples, msm_data, res, verify_ms, device)
    phase("sharding, ring functions and profiling")
    if "--profile" in sys.argv[1:]:
        from secp256k1_tpu_torch.models import ecdsa
        verify_planes = core_planes(triples, LANES, device)
        profile_core(f"_verify_impl at {LANES} lanes",
                     lambda: ecdsa._verify_impl(*verify_planes),
                     [KERNEL_SYMBOL[name] for name in VERIFY_CORE_KERNELS])
        from secp256k1_tpu_torch.models import ecdh
        profile_core(f"_ecdh_e2e_core at {LANES} lanes",
                     lambda: ecdh._ecdh_e2e_core(*ecdh_planes),
                     [KERNEL_SYMBOL[name] for name in ECDH_ENGINES[0][2]])
        from secp256k1_tpu_torch.models import h2c
        profile_core(f"_ro_bytes_core at {LANES} lanes",
                     lambda: h2c._ro_bytes_core(*h2c_planes["RO"]),
                     [KERNEL_SYMBOL[name] for name in H2C_RO_KERNELS])
        profile_core(f"_nu_bytes_core at {LANES} lanes",
                     lambda: h2c._nu_bytes_core(*h2c_planes["NU"]),
                     [KERNEL_SYMBOL[name] for name in H2C_NU_KERNELS])
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--profile-msm"], cwd=HERE, timeout=600)
        if child.returncode:
            fail(f"the profiled MSM process exited {child.returncode}")
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--profile-sign"], cwd=HERE, timeout=600)
        if child.returncode:
            fail(f"the profiled sign core process exited {child.returncode}")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "secp256k1_tpu.")))
    if leaked or "secp256k1_tpu" in sys.modules:
        fail(f"the port pulled in {leaked[:5]}")
    kernels = []
    for name in K.KERNELS:
        src, replaces = KERNEL_META[name]
        per_path = {label: counts[name]
                    for label, counts in PATH_LAUNCHES.items()
                    if counts[name]}
        if not per_path and name not in NO_PATH_KERNELS:
            fail(f"{name} was launched on no path")
        shapes = {}
        if name == "mod_pow_chain":
            shapes = {"by_exponent_and_width_per_path": CHAIN_SHAPES}
        elif name in ("point_add", "point_double"):
            shapes = {"one_lane_launches_per_path": {
                label: c[name] for label, c in ONE_LANE.items()
                if c.get(name)}}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(per_path.values()),
                        "launches_per_path": per_path, **shapes,
                        **res[name], "library_ms": None,
                        "sass": SASS_MIX.get(KERNEL_SYMBOL[name])})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
