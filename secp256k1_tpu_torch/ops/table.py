"""Fixed-base tables and fixed-base scalar multiplication (PyTorch).

The port of the fixed-base half of `secp256k1_tpu.ops.table`: the signed
G tables of every width 4-15 and the unsigned ones of widths 4 and 8
(computed here from python ints and cached in memory, never read from or
written to the JAX package's data directory), the window digits of every
width, `scalar_base_mult` (k*G, secret k) and `scalar_base_mult_add`
(k*G + Q, public k), routed as the JAX package routes them on its TPU
under its own switches:

- `set_base_signed` / `SECP256K1_TPU_BASE_SIGNED` (on by default): signed
  windows of `base_window()` bits, else unsigned 8-bit windows;
- `set_base_window` / `SECP256K1_TPU_BASE_WINDOW` (8 by default, 4-15):
  the signed width.

Where the JAX package's fused kernels would fit their VMEM budget
(`_fused_base_ok`: signed w >= 6, unsigned w = 8) one launch of a
fixed-base kernel does the whole sum on CUDA: `base_windowed_add` (secret
digits, each window's entry selected by an int8 tensor-core product of
one-hot rows with every entry, as the TPU's bf16 one-hot matmul selects it)
or `base_windowed_add_final` (public digits, a gather, then + Q).  Each
reads a packed copy of the G table made once a key (`base_table_bytes`,
`base_table_words`).  Elsewhere (signed w = 4, 5, unsigned w = 4) the scan
path runs a window at a time: a masked select over the window's entries, a
`point_add_mixed` launch, a select on digit 0.  Also the per-lane tables of
Straus's MSM and the not-mega GLV (`build_lane_table`,
`lookup_lane_table`).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import field as fe
from . import limbs as lb
from . import point as pt
from .cuda import kernels as K
from ..utils import hostcurve as hc

P = fe.P
BASE_WINDOW_BITS = 8

_BASE_SIGNED = os.environ.get("SECP256K1_TPU_BASE_SIGNED", "1") != "0"
_BASE_WINDOW = int(os.environ.get("SECP256K1_TPU_BASE_WINDOW", "8"))


def base_signed_enabled() -> bool:
    return _BASE_SIGNED


def set_base_signed(value: bool) -> None:
    global _BASE_SIGNED
    _BASE_SIGNED = bool(value)


def base_window() -> int:
    return _BASE_WINDOW


def set_base_window(value: int) -> None:
    global _BASE_WINDOW
    assert 4 <= value <= 15
    _BASE_WINDOW = int(value)


# ---------------------------------------------------------------------------
# Host-side tables (python ints, cached).
# ---------------------------------------------------------------------------

def _batch_affine_add(pairs):
    """[(P_i, Q_i)] -> [P_i + Q_i] for affine points with P_i != -Q_i and
    neither the identity: one modular inversion for the whole list
    (Montgomery's trick)."""
    p = hc.P
    dens = [(2 * a[1]) % p if a == b else (b[0] - a[0]) % p
            for a, b in pairs]
    prefix = [1]
    for d in dens:
        prefix.append(prefix[-1] * d % p)
    inv = pow(prefix[-1], -1, p)
    out = [None] * len(pairs)
    for i in range(len(pairs) - 1, -1, -1):
        d_inv = inv * prefix[i] % p
        inv = inv * dens[i] % p
        (x1, y1), (x2, y2) = pairs[i]
        num = 3 * x1 * x1 if pairs[i][0] == pairs[i][1] else y2 - y1
        lam = num * d_inv % p
        x3 = (lam * lam - x1 - x2) % p
        out[i] = (x3, (lam * (x1 - x3) - y1) % p)
    return out


def _multiples_np(n_windows: int, n_entries: int, window_bits: int):
    """[n_windows, n_entries, 2, 16] int64 limbs with
    table[w][d - 1] = d * 2^(window_bits * w) * G.  Every window's entries
    grow by doubling their count: entries m+1..2m are entries 1..m plus
    m*B, one batched affine add over all windows a round."""
    bases = [hc.G]
    for _ in range(n_windows - 1):
        b = bases[-1]
        for _ in range(window_bits):
            b = hc.add(b, b)
        bases.append(b)
    rows = [[b] for b in bases]
    while len(rows[0]) < n_entries:
        m = len(rows[0])
        k = min(m, n_entries - m)
        pairs = [(r[i], r[m - 1]) for r in rows for i in range(k)]
        sums = _batch_affine_add(pairs)
        for w, r in enumerate(rows):
            r.extend(sums[w * k:(w + 1) * k])
    coords = b"".join(c.to_bytes(32, "little")
                      for r in rows for point in r for c in point)
    limbs = np.frombuffer(coords, dtype="<u2").astype(np.int64)
    return limbs.reshape(n_windows, n_entries, 2, lb.NLIMBS)


@functools.cache
def gen_base_tables_np(window_bits: int = 4) -> np.ndarray:
    """Unsigned-window affine multiples of G:
    [256 / w, 2^w - 1, 2, 16] int64 limbs, table[w][d-1] =
    d * 2^(window_bits*w) * G for d in 1..2^w - 1 (w in 4, 8)."""
    assert window_bits in (4, 8)
    return _multiples_np(256 // window_bits, (1 << window_bits) - 1,
                         window_bits)


@functools.cache
def gen_base_tables_signed_np(window_bits: int = BASE_WINDOW_BITS):
    """Signed-window affine multiples of G:
    [ceil(256/w) + 1, 2^(w-1), 2, 16] int64 limbs, with
    table[w][d-1] = d * 2^(window_bits*w) * G for d in 1..2^(w-1).  The last
    window absorbs the recoding carry out of the top window."""
    assert 4 <= window_bits <= 15
    return _multiples_np(-(-256 // window_bits) + 1, 1 << (window_bits - 1),
                         window_bits)


_TABLES: dict = {}


def base_table(device, window_bits: int = BASE_WINDOW_BITS,
               signed: bool = True) -> torch.Tensor:
    """The G table of `window_bits`-bit windows, signed or unsigned, as a
    contiguous int32 tensor on `device` (cached per device, width and
    signedness)."""
    key = (str(torch.device(device)), window_bits, signed)
    t = _TABLES.get(key)
    if t is None:
        arr = (gen_base_tables_signed_np(window_bits) if signed
               else gen_base_tables_np(window_bits))
        t = torch.as_tensor(arr, dtype=lb.DTYPE, device=device).contiguous()
        _TABLES[key] = t
        _PACKED[id(t)] = {}
    return t


# The fixed-base kernels' packed copies of a G table, made once a key:
# 32-bit words for base_windowed_add_final's per-lane gather, bytes for
# base_windowed_add's tensor-core one-hot select.
ENTRY_PAD = 32               # the select's entry count rounds up to this


def pack_words(table: torch.Tensor) -> torch.Tensor:
    """int32 [W, E, 2, 16] limbs -> int32 [W, E, 16] little-endian 32-bit
    words (x words 0-7, then y words 0-7): 64 bytes an entry."""
    w, e = table.shape[:2]
    pairs = table.to(torch.int64).reshape(w, e, 16, 2)
    words = pairs[..., 0] | (pairs[..., 1] << 16)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).contiguous()


def pack_bytes(table: torch.Tensor) -> torch.Tensor:
    """int32 [W, E, 2, 16] limbs -> uint8 [W, 64, E_pad], byte-major:
    [w, j, e] is byte j of entry e's 64-byte little-endian (x, y), and
    E_pad is E rounded up to a multiple of ENTRY_PAD, the entries past E
    zero.  Four consecutive entries of one byte column are one 32-bit
    word, the B operand of the kernel's int8 MMA."""
    w, e = table.shape[:2]
    limbs = table.to(torch.int64).reshape(w, e, 32)
    by = torch.stack([limbs & 0xFF, limbs >> 8], -1).reshape(w, e, 64)
    e_pad = -(-e // ENTRY_PAD) * ENTRY_PAD
    out = torch.zeros((w, 64, e_pad), dtype=torch.uint8,
                      device=table.device)
    out[:, :, :e] = by.transpose(1, 2).to(torch.uint8)
    return out


_PACKED: dict = {}   # id of a base_table table -> {form: packed copy}


def packed_of(table: torch.Tensor, form: str) -> torch.Tensor:
    """The packed `form` ("words" or "bytes") of an int32 G table: made
    once and kept where `table` is one of `base_table`'s (which live as
    long as the process, so their ids stay theirs), else packed here."""
    pack = pack_words if form == "words" else pack_bytes
    forms = _PACKED.get(id(table))
    if forms is None:
        return pack(table)
    if form not in forms:
        forms[form] = pack(table)
    return forms[form]


def base_table_words(device, window_bits: int = BASE_WINDOW_BITS,
                     signed: bool = True) -> torch.Tensor:
    """`pack_words` of `base_table(device, window_bits, signed)`."""
    return packed_of(base_table(device, window_bits, signed), "words")


def base_table_bytes(device, window_bits: int = BASE_WINDOW_BITS,
                     signed: bool = True) -> torch.Tensor:
    """`pack_bytes` of `base_table(device, window_bits, signed)`."""
    return packed_of(base_table(device, window_bits, signed), "bytes")


# ---------------------------------------------------------------------------
# Window digits.
# ---------------------------------------------------------------------------

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


def _raw_digits_any(k: torch.Tensor, window_bits: int, n_windows: int):
    """Unsigned window digits for widths that need not divide the 16-bit
    limb: window i spans bits [i*w, (i+1)*w), read from limb pairs
    (bits past 256 are 0).  [n_windows, *B] in [0, 2^window_bits)."""
    k = k.to(lb.WIDE)
    pairs = k | (lb.pad_limbs(k[1:], 0, 1) << lb.LIMB_BITS)    # [16, *B]
    bits = torch.arange(n_windows, device=k.device) * window_bits
    shape = (n_windows,) + (1,) * (k.ndim - 1)
    limb = (bits // lb.LIMB_BITS).reshape(shape)
    shift = (bits % lb.LIMB_BITS).reshape(shape)
    rows = pairs.index_select(0, limb.reshape(-1))
    return (rows >> shift) & ((1 << window_bits) - 1)


def _window_digits(k: torch.Tensor, window_bits: int, n_windows: int):
    if lb.LIMB_BITS % window_bits == 0:
        return _raw_digits(k, window_bits, n_windows)
    return _raw_digits_any(k, window_bits, n_windows)


def _signed_digits(k: torch.Tensor, window_bits: int = BASE_WINDOW_BITS):
    """Canonical scalar plane -> [n_windows + 1, *B] signed window digits,
    least significant first, magnitude (low 16 bits, in [0, 2^(w-1)]) |
    sign << 16, for any width 4-15."""
    n_windows = -(-256 // window_bits)
    return signed_recode(_window_digits(k, window_bits, n_windows),
                         window_bits, 16)


# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication.
# ---------------------------------------------------------------------------

_VMEM_BLK_S = 8          # the JAX package's BLK_S sublanes a grid step


def _fused_base_ok(window_bits: int = BASE_WINDOW_BITS,
                   signed: bool = False) -> bool:
    """Whether one fixed-base kernel launch does the sum: the JAX
    package's rule on its TPU (every window's selected x and y planes of a
    grid step within 6 MiB of VMEM), taken on both devices here."""
    n_windows = (-(-256 // window_bits) + 1) if signed \
        else 256 // window_bits
    return 2 * n_windows * lb.NLIMBS * _VMEM_BLK_S * 128 * 4 <= 6 * 2**20


def lookup_shared_affine(table_w: torch.Tensor, mags: torch.Tensor):
    """One window's lookup: table_w [E, 2, 16] affine entries, mags [*B] in
    [0, E] (d selects entry d - 1; 0 gives (0, 0), which the caller masks).
    A one-hot masked sum over every entry, never an index by the digit
    (sign passes secret digits), in chunks of entries so that the one-hot
    product stays near 512 MiB."""
    n_entries = table_w.shape[0]
    flat = table_w.reshape(n_entries, 2 * lb.NLIMBS).to(lb.DTYPE)
    lanes = max(1, mags.numel())
    chunk = max(1, (1 << 27) // (2 * lb.NLIMBS * lanes))
    sel = torch.zeros((2 * lb.NLIMBS,) + tuple(mags.shape), dtype=lb.DTYPE,
                      device=mags.device)
    for lo in range(0, n_entries, chunk):
        ids = torch.arange(lo + 1, min(lo + chunk, n_entries) + 1,
                           dtype=mags.dtype, device=mags.device)
        ids = ids.reshape((-1,) + (1,) * mags.ndim)
        hot = (ids == mags.unsqueeze(0)).to(lb.DTYPE)           # [e, *B]
        tab = flat[lo:lo + ids.shape[0]].reshape(
            (ids.shape[0], 2 * lb.NLIMBS) + (1,) * mags.ndim)
        sel += (hot.unsqueeze(1) * tab).sum(0, dtype=lb.DTYPE)
    return sel[:lb.NLIMBS], sel[lb.NLIMBS:]


def lookup_shared_affine_all(tables: torch.Tensor, digits: torch.Tensor,
                             onehot_budget: int = 1 << 30):
    """Every window's lookup: tables [W, E, 2, 16] affine entries, digits
    [W, *B] in [0, E] (d selects entry d - 1 of its window, 0 the zero
    row) -> (sel_x, sel_y), each int32 [W, 16, *B].  `lookup_shared_affine`
    a window, stacked: the same constant-time one-hot masked sum, never an
    index by the digit.  onehot_budget is the JAX signature's; the
    per-window call already keeps each one-hot product small."""
    xs, ys = zip(*(lookup_shared_affine(tables[w], digits[w])
                   for w in range(tables.shape[0])))
    return torch.stack(xs), torch.stack(ys)


def _scan_base_mult(table, digits, signed: bool) -> pt.Point:
    """The JAX package's scan path: from the identity, per window a masked
    select of the window's entry, y negated for a set sign bit, a mixed add
    (`point_add_mixed`, one launch on CUDA) and a select on digit 0."""
    mags = digits & 0xFFFF if signed else digits
    acc = pt.identity(tuple(digits.shape[1:]), digits.device)
    for w in range(digits.shape[0]):
        qx, qy = lookup_shared_affine(table[w], mags[w])
        if signed:
            qy = fe.select((digits[w] >> 16) == 1, fe.neg(qy), qy)
        acc = pt.select(mags[w] == 0, acc, pt.add_mixed(acc, qx, qy))
    return acc


def _scalar_base_mult_signed(k: torch.Tensor, window_bits: int) -> pt.Point:
    """Signed-window k*G: ceil(256/w) + 1 windows of 2^(w-1) entries (a
    magnitude lookup and a conditional y negation), zero doublings."""
    digits = _signed_digits(k, window_bits).contiguous()
    table = base_table(k.device, window_bits, signed=True)
    if _fused_base_ok(window_bits, signed=True):
        return pt.Point(*K.base_windowed_add(digits, table))
    return _scan_base_mult(table, digits, signed=True)


def scalar_base_mult(k: torch.Tensor,
                     window_bits: int = BASE_WINDOW_BITS) -> pt.Point:
    """k*G for a secret scalar plane k, zero doublings and one masked mixed
    add per window.  window_bits 8 under the signed default takes the
    signed windows of `base_window()` bits; otherwise unsigned windows of
    window_bits (4 or 8) with 2^w - 1 entries.  On the fused path one
    launch of the constant-time fixed-base kernel, which selects each
    window's entry by a one-hot product with every entry of the window;
    else the scan path."""
    if window_bits == 8 and _BASE_SIGNED:
        return _scalar_base_mult_signed(k, _BASE_WINDOW)
    table = base_table(k.device, window_bits, signed=False)
    digits = _raw_digits(k, window_bits, table.shape[0]).to(
        lb.DTYPE).contiguous()
    if _fused_base_ok(window_bits):
        return pt.Point(*K.base_windowed_add(digits, table,
                                             signed_digits=False))
    return _scan_base_mult(table, digits, signed=False)


def scalar_base_mult_add(k: torch.Tensor, q: pt.Point,
                         window_bits: int = BASE_WINDOW_BITS) -> pt.Point:
    """k*G + Q.  Under the signed default with a fused width: one launch
    of the fixed-base kernel with the final complete add of Q.  Otherwise
    `add(scalar_base_mult(k, window_bits), Q)`, as the JAX package falls
    back."""
    if window_bits == 8 and _BASE_SIGNED \
            and _fused_base_ok(_BASE_WINDOW, signed=True):
        digits = _signed_digits(k, _BASE_WINDOW).contiguous()
        x, y, z = K.base_windowed_add_final(
            digits, base_table(k.device, _BASE_WINDOW, signed=True),
            q.x.contiguous(), q.y.contiguous(), q.z.contiguous())
        return pt.Point(x, y, z)
    return pt.add(scalar_base_mult(k, window_bits), q)


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
