"""Profiling and the H100 yardstick: traces, slope timing, roofline bounds.

The port of `secp256k1_tpu.utils.profiling`.  `trace` is a
`torch.profiler` session, `timed_chain` times by CUDA events on the card,
and the bounds are the H100's (none of the JAX module's TPU v5e figures
carries over): bytes over the HBM rate, 32-bit integer products over the
multiply-add rate of the SMs at their maximum clock, int8 tensor-core
operations over the dense int8 rate.  `chip_smoke.py` takes its bounds from
here.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time

import torch

# Published H100 SXM figures (NVIDIA data sheet; CUDA C++ Programming
# Guide, arithmetic instruction throughput for compute capability 9.0: 64
# results per clock per SM for 32-bit integer multiply-add; H100
# architecture whitepaper: 4 tensor cores an SM, each 1,024 dense int8
# multiply-adds a clock).  The SM count and maximum SM clock are the card's.
HBM_BYTES_PER_S = 3.35e12
INT_MAD_PER_CLOCK_PER_SM = 64
INT8_MAC_PER_CLOCK_PER_SM = 4096

# 32 x 32 -> 64-bit products per lane, counted from csrc/field.cuh and
# csrc/point.cuh (a product by a constant word 1 compiles to no multiply):
# schoolbook 64, square 36; the fold mod p (c = 2^32 + 977) 8 + 2 + 1 + 1,
# mod n (c of five words, the top one 1) 32 + 20 + 4 + 4; a product by
# b3 = 21 is 8 + 1 + 1.
MUL_P, SQR_P, MUL_N, SQR_N, MULW_P = 64 + 12, 36 + 12, 64 + 60, 36 + 60, 10
PT_ADD = 12 * MUL_P + 2 * MULW_P          # RCB Algorithm 7
PT_ADD_MIXED = 11 * MUL_P + 2 * MULW_P    # Algorithm 8
PT_DOUBLE = 2 * SQR_P + 6 * MUL_P + MULW_P  # Algorithm 9

# A plane is 16 int32 limbs a lane; a point op reads and writes 3 a point.
PLANE_BYTES = 16 * 4
POINT_OPS = {"point_add": (PT_ADD, 9 * PLANE_BYTES),
             "point_double": (PT_DOUBLE, 6 * PLANE_BYTES)}

# RFC 6979's DRBG (csrc/drbg.cu): 32-bit integer operations of one SHA-256
# compression as the card issues them (a rotation one funnel shift; a
# three-input XOR, choice or majority one LOP3; two additions one IADD3):
# 14 a round, 10 a schedule word, 8 to add the state.
SHA256_BLOCK_OPS = 64 * 14 + 48 * 10 + 8


def rfc6979_blocks(extra: bool, attempt: int) -> int:
    """SHA-256 compressions of one lane of `kernels.rfc6979_nonce`: 16 to
    seed with key || e and give the first candidate (18 with additional
    data), 8 for each further candidate."""
    return (18 if extra else 16) + 8 * attempt


def bip340_blocks(length: int) -> int:
    """SHA-256 compressions of one lane of `kernels.bip340_challenge` with
    an L-byte message: R.x || P.x after the tag's constant midstate, then
    m, the 0x80 byte and the 8-byte bit length."""
    return 1 + (length + 9 + 63) // 64


def xmd_blocks(length: int, dst_prime_len: int, n_out: int) -> int:
    """SHA-256 compressions of one lane of `kernels.expand_xmd` with an
    L-byte message under an |DST'|-byte DST': b0 after the constant Z_pad
    midstate, the message and I2OSP(n_out, 2) || 0x00 || DST' with the
    padding; then each of the ell b_i, 33 + |DST'| bytes with the
    padding."""
    ell = (n_out + 31) // 32
    return (length + 3 + dst_prime_len + 9 + 63) // 64 \
        + ell * ((33 + dst_prime_len + 9 + 63) // 64)


TRACE_FILE = "trace.json"


def peak_int_rate(sm_count: int, sm_clock_mhz: float) -> float:
    """Peak 32-bit integer multiply-adds a second."""
    return sm_count * INT_MAD_PER_CLOCK_PER_SM * sm_clock_mhz * 1e6


def max_sm_clock_mhz() -> float:
    """GPU 0's maximum SM clock, as `nvidia-smi` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def int8_rate(int_rate):
    """Dense int8 MMA operations a second (two a multiply-add) at the SM
    count and clock that set `int_rate`."""
    return int_rate / INT_MAD_PER_CLOCK_PER_SM * INT8_MAC_PER_CLOCK_PER_SM * 2


def bound_terms(int_rate, products_total, bytes_total, mma_ops=0):
    """Milliseconds of each term of the bound: the 32-bit products over
    the integer multiply-add rate, the int8 MMA operations over the dense
    int8 tensor rate (the two units run side by side), the bytes over the
    HBM rate."""
    return {"products": products_total / int_rate * 1e3,
            "int8_mma": mma_ops / int8_rate(int_rate) * 1e3,
            "bytes": bytes_total / HBM_BYTES_PER_S * 1e3}


def bound_ms(int_rate, products_total, bytes_total, mma_ops=0):
    """(least milliseconds, what sets it: "operations" or "bytes"): the
    largest term of `bound_terms`."""
    terms = bound_terms(int_rate, products_total, bytes_total, mma_ops)
    t_ops = max(terms["products"], terms["int8_mma"])
    return (t_ops, "operations") if t_ops >= terms["bytes"] \
        else (terms["bytes"], "bytes")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A `torch.profiler` session (CPU activities, and CUDA where there is
    a card) around a block; yields `log_dir` and writes the Chrome trace
    `log_dir/trace.json` at its end (view in Perfetto or chrome://tracing).
    Default `log_dir`: secp256k1_tpu_torch_trace in the temporary
    directory."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "secp256k1_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def timed_chain(fn, args, n_reps_small: int = 1, n_reps_big: int = 4,
                reps: int = 3) -> float:
    """Seconds per call of fn(*args) from the slope between chains of
    n_reps_small and n_reps_big calls back to back (eager PyTorch hoists
    nothing), the best of `reps` of each: the constant cost of starting
    and reading back cancels.  CUDA events and a synchronize when a tensor
    of `args` is on the card, `time.perf_counter` otherwise."""
    on_card = any(t.is_cuda for t in _tensors(args))

    def run(n):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return time.perf_counter() - t0

    run(1)
    best = {n: min(run(n) for _ in range(reps))
            for n in (n_reps_small, n_reps_big)}
    return max((best[n_reps_big] - best[n_reps_small])
               / (n_reps_big - n_reps_small), 1e-9)


def roofline_report(lanes: int, measured_s: float, op: str = "point_add",
                    sm_count: int | None = None,
                    sm_clock_mhz: float | None = None) -> dict:
    """A measured time of one `op` launch over `lanes` lanes against the
    H100's bounds: its 32-bit products (PT_ADD or PT_DOUBLE a lane) over
    the integer rate of `sm_count` SMs at `sm_clock_mhz` (default: the
    card's), and the bytes of its planes read and written over the HBM
    rate.  The keys of the JAX report, and the bound with what sets it."""
    products, nbytes = POINT_OPS[op]
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    if sm_clock_mhz is None:
        sm_clock_mhz = max_sm_clock_mhz()
    rate = peak_int_rate(sm_count, sm_clock_mhz)
    terms = bound_terms(rate, lanes * products, lanes * nbytes)
    bound, by = bound_ms(rate, lanes * products, lanes * nbytes)
    return {
        "op": op,
        "lanes": lanes,
        "measured_s": measured_s,
        "compute_bound_s": terms["products"] / 1e3,
        "memory_bound_s": terms["bytes"] / 1e3,
        "pct_of_compute_roofline": round(
            100 * terms["products"] / 1e3 / measured_s, 1),
        "bound_s": bound / 1e3,
        "bound_by": by,
        "pct_of_roofline": round(100 * bound / 1e3 / measured_s, 1),
    }
