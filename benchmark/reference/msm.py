"""The expected sum of a multi-scalar multiplication over pool points of
known discrete log.

Lane i holds scalar s_i and pool point P_j = a_j G with j = src[i], so the
sum is (sum_i s_i a_src[i] mod n) G.  The scalars of each pool point are
summed in NumPy, 16 bits a column (at most 2^16 - 1 times the lanes that
share a point, exact in float64 up to 2^37 lanes), then carried into python
ints.
"""

from __future__ import annotations

import numpy as np

from . import curve


def expected_sum(scalars: np.ndarray, src: np.ndarray, logs: list,
                 comb: curve.Comb) -> bytes:
    """The 65-byte SEC1 encoding of sum_i s_i P_src[i], or b"\\x00" for the
    point at infinity.  scalars: [n, 32] u8 big-endian; src: [n] pool
    indices; logs: the pool's discrete logs."""
    cols = scalars.view(">u2").astype(np.float64)          # [n, 16] BE
    pool = len(logs)
    sums = np.stack([np.bincount(src, weights=cols[:, m], minlength=pool)
                     for m in range(16)]).astype(np.int64)  # [16, pool]
    limbs = np.zeros((17, pool), np.int64)
    carry = np.zeros(pool, np.int64)
    for m in range(15, -1, -1):
        v = sums[m] + carry
        limbs[m + 1] = v & 0xFFFF
        carry = v >> 16
    limbs[0] = carry
    rows = limbs.T.astype(">u2").tobytes()
    t = 0
    for j, a in enumerate(logs):
        t += int.from_bytes(rows[34 * j:34 * j + 34], "big") * a
    total = comb.mul_batch([t % curve.N])[0]
    return b"\x00" if total is None else curve.uncompressed(total)
