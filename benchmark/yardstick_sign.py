"""The algorithmic work of the constant-time fixed-base kernel #6
`k_base_scan` (k * G of a secret nonce), frozen here beside `yardstick.py`,
whose rates and counts it uses.

The kernel's design (signed 8-bit windows over the int8 tensor cores'
select): 33 windows of signed digits, the first taken from the table and
each later nonzero digit one mixed addition (Renes-Costello-Batina
Algorithm 8: 11 field products and 2 products by b3).  For a uniform
nonce a digit of windows 1-31 is zero with probability 1/256, and the top
window holds only the recoding's carry, nonzero half the time: 31 * 255/256
+ 1/2 additions a lane.  The select's int8 tensor-core work (2 x 128 x 64
operations a window) is bound below the products at 65,536 lanes (0.0166
against 0.1052 ms on 132 SMs at 1,980 MHz), so the products set the
bound.  Bytes: the digits and the three output planes a lane, and the
table (33 windows of 64 x 128 bytes) once.  The count is a function of the
lanes the reference says were signed, never of what an implementation
launches.
"""

from __future__ import annotations

import yardstick

BASE_WINDOWS = 33
BASE_ENTRIES = 128
PT_ADD_MIXED = 11 * yardstick.MUL_P + 2 * yardstick.MULW_P
BASE_ADDS = (BASE_WINDOWS - 2) * 255 / 256 + 1 / 2


def base_scan_work(lanes: int):
    """(products, bytes) of k * G on `lanes` lanes of signed 8-bit
    windows."""
    products = lanes * BASE_ADDS * PT_ADD_MIXED
    nbytes = (lanes * (BASE_WINDOWS * 4 + 3 * yardstick.PLANE_BYTES)
              + BASE_WINDOWS * 64 * BASE_ENTRIES)
    return products, nbytes
