"""Fixed-base tables and fixed-base scalar multiplication (PyTorch).

The port of the signed 8-bit path of `secp256k1_tpu.ops.table`: the signed
G table (computed here from python ints and cached in memory, never written
to the JAX package's data directory), the signed window recoding,
`scalar_base_mult` (k*G, secret k) and `scalar_base_mult_add` (k*G + Q,
public k), each one launch of a fixed-base kernel on CUDA.  The kernels
select the table entries themselves, so the TPU's bf16 one-hot selection
planes are not ported: verify's kernel gathers table[w][|d| - 1] (public
digits), the secret-digit kernel scans every entry of a window.  The window
is fixed at 8 bits.  Also the per-lane tables of Straus's MSM
(`build_lane_table`, `lookup_lane_table`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from . import point as pt
from .cuda import kernels as K
from ..utils import hostcurve as hc

BASE_WINDOW_BITS = 8


@functools.cache
def gen_base_tables_signed_np(window_bits: int = BASE_WINDOW_BITS):
    """Signed-window affine multiples of G:
    [ceil(256/w) + 1, 2^(w-1), 2, 16] int64 limbs, with
    table[w][d-1] = d * 2^(window_bits*w) * G for d in 1..2^(w-1).  The last
    window absorbs the recoding carry out of the top window."""
    assert 4 <= window_bits <= 15
    n_windows = -(-256 // window_bits) + 1
    n_entries = 1 << (window_bits - 1)
    out = np.zeros((n_windows, n_entries, 2, lb.NLIMBS), dtype=np.int64)
    base = hc.G
    for w in range(n_windows):
        acc = None
        for d in range(1, n_entries + 1):
            acc = hc.add(acc, base)
            out[w, d - 1, 0] = lb.int_to_limbs(acc[0])
            out[w, d - 1, 1] = lb.int_to_limbs(acc[1])
        for _ in range(window_bits):
            base = hc.add(base, base)
    return out


_TABLES: dict = {}


def base_table(device) -> torch.Tensor:
    """The signed G table (8-bit windows) as a contiguous int32 tensor on
    `device`."""
    key = str(torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.as_tensor(gen_base_tables_signed_np(BASE_WINDOW_BITS),
                            dtype=lb.DTYPE, device=device).contiguous()
        _TABLES[key] = t
    return t


def signed_recode(d: torch.Tensor, window_bits: int, sign_shift: int):
    """Unsigned window digits [W, *B] (least significant first, each in
    [0, 2^w)) -> [W + 1, *B] signed digits, magnitude | sign << sign_shift,
    least significant first.  A digit t = d + carry in (2^(w-1), 2^w]
    becomes t - 2^w with a carry of 1 into the next window; the last window
    holds the final carry.  The carry chain is a lookahead: window i
    generates a carry when d > 2^(w-1) and propagates one when
    d == 2^(w-1)."""
    half = 1 << (window_bits - 1)
    full = 1 << window_bits
    d = d.to(lb.WIDE)
    gen = (d > half).to(lb.WIDE)
    prop = (d == half).to(lb.WIDE)
    cin, cout = lb.carry_chain(gen, prop)
    t = d + cin
    neg = t > half
    mag = torch.where(neg, full - t, t)
    out = mag | (neg.to(lb.WIDE) << sign_shift)
    return torch.cat([out, cout.unsqueeze(0)], 0).to(lb.DTYPE)


def _raw_digits(k: torch.Tensor, window_bits: int, n_windows: int):
    """Unsigned window digits of a canonical scalar plane, least significant
    window first: [n_windows, *B] in [0, 2^window_bits).  window_bits
    divides 16."""
    per_limb = lb.LIMB_BITS // window_bits
    k = k.to(lb.WIDE)
    shifts = torch.arange(per_limb, device=k.device) * window_bits
    d = (k.unsqueeze(1) >> shifts.reshape((1, per_limb) + (1,) *
                                          (k.ndim - 1))) \
        & ((1 << window_bits) - 1)
    return d.reshape((k.shape[0] * per_limb,) + tuple(k.shape[1:]))[
        :n_windows]


def _signed_digits(k: torch.Tensor, window_bits: int = BASE_WINDOW_BITS):
    """Canonical scalar plane -> [n_windows + 1, *B] signed window digits,
    least significant first, magnitude (low 16 bits, in [0, 2^(w-1)]) |
    sign << 16."""
    assert lb.LIMB_BITS % window_bits == 0
    n_windows = -(-256 // window_bits)
    return signed_recode(_raw_digits(k, window_bits, n_windows),
                         window_bits, 16)


def scalar_base_mult(k: torch.Tensor) -> pt.Point:
    """k*G for a secret scalar plane k: signed 8-bit fixed-base windows
    (zero doublings, one mixed add per window, digit 0 passed through), in
    one launch of the constant-time fixed-base kernel on CUDA, which
    selects each window's entry by a masked scan of the whole window."""
    x, y, z = K.base_windowed_add(_signed_digits(k).contiguous(),
                                  base_table(k.device))
    return pt.Point(x, y, z)


def scalar_base_mult_add(k: torch.Tensor, q: pt.Point) -> pt.Point:
    """k*G + Q: signed 8-bit fixed-base windows (zero doublings, one mixed
    add per window, digit 0 passed through) and a final complete add of Q,
    in one kernel launch on CUDA."""
    digits = _signed_digits(k)
    x, y, z = K.base_windowed_add_final(
        digits.contiguous(), base_table(k.device),
        q.x.contiguous(), q.y.contiguous(), q.z.contiguous())
    return pt.Point(x, y, z)


# ---------------------------------------------------------------------------
# Per-lane tables (Straus).
# ---------------------------------------------------------------------------

def lookup_lane_table(table: torch.Tensor, digits: torch.Tensor) -> pt.Point:
    """Per-lane lookup: table [E, 3, 16, B] (entry d - 1 = d*P per lane),
    digits [B] in [0, E].  A masked sum over all E entries, never a gather
    by the digit: every lane reads every entry.  Digit 0 gives (0, 0, 0)."""
    e = table.shape[0]
    idx = torch.arange(1, e + 1, dtype=digits.dtype, device=digits.device)
    mask = (digits.unsqueeze(0) == idx.unsqueeze(1)).to(table.dtype)
    sel = (table * mask[:, None, None]).sum(0, dtype=table.dtype)
    return pt.Point(sel[0], sel[1], sel[2])


def build_lane_table(p: pt.Point, n_entries: int = 15) -> torch.Tensor:
    """[d*P for d in 1..n_entries] stacked as int32 [E, 3, 16, B]: one
    doubling and E - 2 complete adds, batched over the lanes."""
    p2 = pt.double(p)
    rows = [torch.stack(list(p)), torch.stack(list(p2))]
    acc = p2
    for _ in range(n_entries - 2):
        acc = pt.add(acc, p)
        rows.append(torch.stack(list(acc)))
    return torch.stack(rows)
