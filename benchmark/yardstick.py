"""The H100's peaks and the algorithmic work of each kernel whose roofline
share the benchmark reports: frozen here, so that a change to the program
is read against the same work.

The rates are NVIDIA's published figures for the H100 SXM (data sheet; CUDA
C++ Programming Guide, arithmetic instruction throughput of compute
capability 9.0: 64 results a clock an SM for the 32-bit integer
multiply-add).  The SM count and the maximum SM clock are read from the
card.  A product count is of 32 x 32 -> 64-bit products: a field
multiplication mod p is 64 for the schoolbook product and 12 for the fold
by c = 2^32 + 977, a square 36 + 12, a product by b3 = 21 is 10; the
complete projective addition and doubling are Renes-Costello-Batina
Algorithms 7 and 9.  Each count is a function of the shapes and of the
algorithm, never of what an implementation launches.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT_MAD_PER_CLOCK_PER_SM = 64

MUL_P, SQR_P, MULW_P = 64 + 12, 36 + 12, 10
PT_ADD = 12 * MUL_P + 2 * MULW_P
PT_DOUBLE = 2 * SQR_P + 6 * MUL_P + MULW_P
PLANE_BYTES = 16 * 4              # one coordinate: 16 limbs of 32 bits

# u2 * Q by the signed 4-bit GLV schedule on k1, k2 < 2^128: 33 windows of
# signed digits each, 2 + 4 * 32 doublings, 12 additions to build the two
# 8-entry tables and one addition a nonzero digit of the 32 low windows of
# each half (a signed 4-bit window is zero with probability 1/16).
GLV_WINDOWS = 33
GLV_DOUBLES = 2 + 4 * (GLV_WINDOWS - 1)
GLV_ADDS = 12 + 2 * (GLV_WINDOWS - 1) * 15 / 16

# Pippenger's bucket accumulation at 4-bit windows: 64 windows, 15
# buckets a window, one complete addition a nonzero digit.
MSM_WINDOW_BITS = 4
MSM_WINDOWS = 256 // MSM_WINDOW_BITS
MSM_BUCKETS = (1 << MSM_WINDOW_BITS) - 1


def int_rate(sm_count: int, max_sm_clock_mhz: float) -> float:
    """Peak 32-bit integer multiply-adds a second."""
    return sm_count * INT_MAD_PER_CLOCK_PER_SM * max_sm_clock_mhz * 1e6


def bound_ms(rate: float, products: float, nbytes: float):
    """(least milliseconds, what sets it): products over the integer rate
    or bytes over the HBM rate, whichever is larger."""
    t_ops = products / rate * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def glv_signed_work(lanes: int):
    """(products, bytes) of the GLV variable-base multiply on `lanes`
    lanes: it reads two digit planes of 33 words and the two points'
    coordinates, and writes one point."""
    products = lanes * (GLV_DOUBLES * PT_DOUBLE + GLV_ADDS * PT_ADD)
    nbytes = lanes * (2 * GLV_WINDOWS * 4 + 9 * PLANE_BYTES)
    return products, nbytes


def msm_buckets_work(scalars: np.ndarray):
    """(products, bytes) of the bucket accumulation of every window over
    [n, 32] big-endian scalar rows: one addition a nonzero 4-bit digit; it
    reads a digit word a window and the three coordinates of each point,
    and writes every window's buckets."""
    n = scalars.shape[0]
    adds = int(np.count_nonzero(scalars >> 4)
               + np.count_nonzero(scalars & 0x0F))
    nbytes = (MSM_WINDOWS * 4 * n + 3 * PLANE_BYTES * n
              + MSM_WINDOWS * MSM_BUCKETS * 3 * PLANE_BYTES)
    return adds * PT_ADD, nbytes
