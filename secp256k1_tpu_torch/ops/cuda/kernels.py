"""The port's kernels: wrappers, plain versions, launch counts, and the
GLV engine switches.

Each TPU kernel of `secp256k1_tpu/ops/pallas/kernels.py` has here

- a wrapper (`mod_mul`, `mod_square`, `mod_pow2k`,
  `glv_windowed_mult_signed_from_points`, `base_windowed_add_final`,
  `base_windowed_add`, `glv_windowed_mult_from_points`,
  `msm_bucket_accumulate_all`, `glv_windowed_mult`, `point_add`,
  `point_double`, `point_double4`, `point_add_mixed`,
  `point_lookup_add`): given
  CPU tensors it runs the plain version; given CUDA tensors it launches the
  hand-written CUDA kernel (`csrc/*.cu`, built by `build.py`) or raises.
  There is no fallback from the kernel to the plain version;
- a plain PyTorch version (`*_plain`) of the same function, which the CPU
  tests run and `chip_smoke.py` compares the kernel with on the card;
- a count of launches (`LAUNCHES`), raised by one where the wrapper
  launches its kernel and nowhere else, and a count of wrapper calls that
  took the plain version (`PLAIN_CALLS`); launches are also tallied by
  their shape (`SHAPES`).

Two more wrappers run a chain of those kernels' work in one launch, where
the JAX package runs the chain of `pallas_call`s inside one compiled
program: `mod_pow_chain` (x^e for a public constant e: the chains of
`ModRing.pow_const_chain`, of which `mod_pow2k` is the one-step case) and
`msm_fold` (the Horner fold of `msm.combine_windows`).  Three replace no
TPU kernel, since the JAX package runs what they compute on its host:
`rfc6979_nonce`, RFC 6979's DRBG, `bip340_challenge`, BIP-0340's
challenge hash, and `expand_xmd`, RFC 9380's expand_message_xmd.

Planes are int32 [16, B] tensors of 16-bit limbs (limb-major, so adjacent
CUDA threads read adjacent lanes), canonical (< modulus) in and out.
Digit planes are int32 [W, B]; per-lane point tables int32 [15, 3, 16, B];
the byte planes of the DRBG and the challenge hash uint8 [32, B] (row j
byte j of each lane's big-endian value; a message of L bytes [L, B]);
`expand_xmd` reads messages as rows [n, W] uint8 with lengths [n] and
writes uint8 [48, k B] planes.

The switches `mega_enabled`/`set_mega` and
`mega_signed_enabled`/`set_mega_signed` are the JAX package's own
(`SECP256K1_TPU_MEGA`, `SECP256K1_TPU_MEGA_SIGNED`, read at import, both on
by default): `ops/glv.py` takes the GLV engine they name on both devices.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ... import native
from ...utils import batching as bt
from .. import limbs as lb
from . import build

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
MOD_ID = {P: 0, N: 1}

KERNELS = ("mod_mul", "mod_square", "mod_pow2k",
           "glv_windowed_mult_signed_from_points", "base_windowed_add_final",
           "base_windowed_add", "glv_windowed_mult_from_points",
           "msm_bucket_accumulate_all", "glv_windowed_mult", "point_add",
           "point_double", "point_double4", "point_add_mixed",
           "point_lookup_add", "mod_pow_chain", "msm_fold", "rfc6979_nonce",
           "bip340_challenge", "expand_xmd")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
# Launches by (kernel, lanes, detail): detail the exponent of mod_pow_chain,
# k of mod_pow2k, the window bits of msm_fold (lanes: its windows), the
# attempt of rfc6979_nonce, the message length of bip340_challenge, the
# row width of expand_xmd, else None.
SHAPES: dict = {}


# The whole GLV loop in one launch (mega), with signed 8-entry windows
# (signed) or unsigned 15-entry ones; off: lane tables, point_double4 and
# point_lookup_add launches.
_MEGA = os.environ.get("SECP256K1_TPU_MEGA", "1") != "0"
_MEGA_SIGNED = os.environ.get("SECP256K1_TPU_MEGA_SIGNED", "1") != "0"


def mega_enabled() -> bool:
    return _MEGA


def set_mega(value: bool) -> None:
    global _MEGA
    _MEGA = bool(value)


def mega_signed_enabled() -> bool:
    return _MEGA_SIGNED


def set_mega_signed(value: bool) -> None:
    global _MEGA_SIGNED
    _MEGA_SIGNED = bool(value)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    SHAPES.clear()


def _on_cpu(*ts) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs on {sorted(kinds)}: a kernel wrapper takes "
                     "tensors that all lie on the CPU or all on one GPU")


def _check(name: str, t: torch.Tensor, rows: int, lanes: int,
           dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 2 or t.shape[0] != rows \
            or t.shape[1] != lanes or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} [{rows}, {lanes}] tensor, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


_CONFIGURED: set = set()


def _launch(kernel: str, lib_name: str, fn_name: str, ptrs, ints,
            shape=None) -> None:
    """Launch `fn_name` of lib<lib_name>.so on the current stream: tensor
    pointers, then ints, then the stream.  Counts the launch under `kernel`
    and its shape (lanes, detail) in SHAPES."""
    lib = build.library(lib_name)
    fn = getattr(lib, fn_name)
    if (lib_name, fn_name) not in _CONFIGURED:
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
            + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CONFIGURED.add((lib_name, fn_name))
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*[t.data_ptr() for t in ptrs], *[int(i) for i in ints], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1
    if shape is not None:
        key = (kernel, *shape)
        SHAPES[key] = SHAPES.get(key, 0) + 1


def _c_limbs(modulus: int):
    c = (1 << 256) - modulus
    return lb.int_to_limbs(c, (c.bit_length() + 15) // 16)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def mod_mul_plain(a, b, modulus: int) -> torch.Tensor:
    """a * b mod m (m in {p, n}), canonical int32 [16, B]: the schoolbook
    product, then the Solinas fold, as the JAX ring's jnp path does."""
    return lb.mod_fold(lb.mul_wide(a, b), _c_limbs(modulus)).to(lb.DTYPE)


def mod_square_plain(a, modulus: int) -> torch.Tensor:
    return mod_mul_plain(a, a, modulus)


def mod_pow2k_plain(a, k: int, modulus: int) -> torch.Tensor:
    """a^(2^k) mod m: k squarings."""
    for _ in range(k):
        a = mod_square_plain(a, modulus)
    return a


# A step of an exponentiation chain, (src, k, mul, dst): acc = slot[src]
# (src POW_ACC: keep acc), k squarings, acc *= slot[mul] (unless POW_ACC),
# slot[dst] = acc (unless POW_ACC); slot 0 holds x.  The kernel takes each
# step as one word (`csrc/modops.cuh`).
POW_ACC = 63
POW_MAX_STEPS = 64
POW_MAX_SLOTS = 24


def chain_runs(e: int) -> list:
    """Runs of (ones, zeros) in the binary expansion of e, MSB first."""
    bits = bin(e)[2:]
    runs = []
    i = 0
    while i < len(bits):
        j = i
        while j < len(bits) and bits[j] == "1":
            j += 1
        k = j
        while k < len(bits) and bits[k] == "0":
            k += 1
        runs.append((j - i, k - j))
        i = k
    return runs


@functools.cache
def pow_chain_steps(e: int) -> tuple:
    """The steps of x^e for a constant e >= 1, a run-decomposition chain
    like the JAX `ModRing.pow_const_chain`'s (the same value, fewer
    squarings).  First every x^(2^r - 1) that a run length r of e needs is
    built, shortest first, in slots: from the longest q <= r built so far,
    x^(2^2q - 1) = (x^(2^q - 1))^(2^q) x^(2^q - 1) while 2q <= r, then
    x^(2^r - 1) = (x^(2^q - 1))^(2^(r-q)) x^(2^(r-q) - 1) (r - q built the
    same way).  So the longest run (223 ones of p - 2) costs 222 squarings
    and some shorter runs' values come on the way.  Then each run of the
    exponent, most significant first: squarings over the zeros before it
    and its ones, times x^(2^ones - 1).  e = 2^k is one step: k squarings
    of x.  Depends on e only."""
    if e < 1:
        raise ValueError(f"pow_chain_steps: e must be >= 1, got {e}")
    runs = chain_runs(e)
    slot = {1: 0}                     # r -> slot of x^(2^r - 1)
    steps = []

    def build(r):
        if r in slot:
            return slot[r]
        q = max(v for v in slot if v <= r)
        while 2 * q <= r:
            if 2 * q not in slot:
                s = slot[q]
                slot[2 * q] = len(slot)
                steps.append((s, q, s, slot[2 * q]))
            q *= 2
        if q < r:
            m = build(r - q)
            slot[r] = len(slot)
            steps.append((slot[q], r - q, m, slot[r]))
        return slot[r]

    for ones in sorted({ones for ones, _ in runs}):
        build(ones)
    src, pending = slot[runs[0][0]], runs[0][1]
    for ones, zeros in runs[1:]:
        steps.append((src, pending + ones, slot[ones], POW_ACC))
        src, pending = POW_ACC, zeros
    if src != POW_ACC or pending:
        steps.append((src, pending, POW_ACC, POW_ACC))
    if len(steps) > POW_MAX_STEPS or len(slot) > POW_MAX_SLOTS \
            or max(k for _, k, _, _ in steps) >= 1 << 12:
        raise ValueError(f"pow_chain_steps: the chain of {e:#x} takes "
                         f"{len(steps)} steps and {len(slot)} slots, more "
                         f"than the kernel holds")
    return tuple(steps)


@functools.cache
def _pow_chain_words(e: int) -> torch.Tensor:
    """The steps of e as the kernel's words, an int32 tensor on the host."""
    words = [k | src << 12 | mul << 18 | dst << 24
             for src, k, mul, dst in pow_chain_steps(e)]
    return torch.tensor(words, dtype=torch.int32)


def mod_pow_chain_plain(a, e: int, modulus: int) -> torch.Tensor:
    """a^e mod m: the steps of `pow_chain_steps(e)` by the plain
    `mod_pow2k` and `mod_mul`.  Zero maps to 0."""
    slots = {0: a}
    acc = a
    for src, k, mul, dst in pow_chain_steps(e):
        if src != POW_ACC:
            acc = slots[src]
        acc = mod_pow2k_plain(acc, k, modulus)
        if mul != POW_ACC:
            acc = mod_mul_plain(acc, slots[mul], modulus)
        if dst != POW_ACC:
            slots[dst] = acc
    return acc


def _glv_plain(d1, d2, t1, t2, signed: bool, from_identity: bool):
    """The GLV loop over lists of per-lane table entries t1, t2 (entry e
    holds (e + 1) * P).  Digits [W, B], most significant window first:
    magnitude | sign << 4 when signed (y negated for a set sign bit), else
    the magnitude alone.  from_identity: start from the identity and double
    4 times in window 0 too (`_glv_mega_kernel`); else window 0 is a select
    from table 1 with the whole identity where the magnitude is 0, then a
    lookup-add from table 2 (`_glv_mega_frompoints_kernel`).  Each later
    window: 4 doublings, then 2 masked lookup-adds (the accumulator passed
    through for magnitude 0).  Returns canonical (x, y, z) planes."""
    from .. import field as fe
    from .. import point as pt
    f = fe.F_PLAIN
    zero = torch.zeros((lb.NLIMBS,) + tuple(d1.shape[1:]), dtype=lb.DTYPE,
                       device=d1.device)

    def select_entry(tab, d):
        mag = d & 0xF if signed else d
        sel = pt.Point(zero, zero, zero)
        for e, ent in enumerate(tab):
            sel = pt.select(mag == e + 1, ent, sel)
        if signed:
            is_neg = (d >> 4) == 1
            sel = pt.Point(sel.x, f.select(is_neg, f.neg(sel.y), sel.y),
                           sel.z)
        return sel, mag

    def lookup_add(acc, tab, d):
        sel, mag = select_entry(tab, d)
        return pt.select(mag == 0, acc, pt.add(acc, sel, f))

    if from_identity:
        acc, w0 = pt.identity(d1.shape[1:], d1.device), 0
    else:
        sel0, mag0 = select_entry(t1, d1[0])
        one = f.one(d1.shape[1:], d1.device)
        acc = pt.Point(sel0.x, f.select(mag0 == 0, one, sel0.y), sel0.z)
        acc, w0 = lookup_add(acc, t2, d2[0]), 1
    for w in range(w0, d1.shape[0]):
        for _ in range(4):
            acc = pt.double(acc, f)
        acc = lookup_add(acc, t1, d1[w])
        acc = lookup_add(acc, t2, d2[w])
    return tuple(c.contiguous() for c in acc)


def _build_table_plain(p, n_entries):
    """[P, 2P, .., E*P]: 1 doubling and E - 2 complete adds."""
    from .. import field as fe
    from .. import point as pt
    p = pt.Point(*p)
    tab = [p, pt.double(p, fe.F_PLAIN)]
    for _ in range(2, n_entries):
        tab.append(pt.add(tab[-1], p, fe.F_PLAIN))
    return tab


def glv_windowed_mult_signed_from_points_plain(d1, d2, p1, p2):
    """k1*P1 + k2*P2 from signed 4-bit window digits, the function of the
    Pallas `_glv_mega_frompoints_kernel(signed_digits=True, n_entries=8)`.

    d1, d2: int32 [W, B] digits, most significant window first, each
    magnitude (bits 0-3, in [0, 8]) | sign << 4.  p1, p2: (x, y, z) planes.
    Per lane: tables [P, 2P, .., 8P] (1 doubling + 6 complete adds); window
    0 is a masked select with the whole identity where the magnitude is 0;
    then per window 4 doublings and 2 masked lookup-adds (y negated for a
    set sign bit, accumulator passed through for magnitude 0).  Returns
    canonical (x, y, z) planes."""
    return _glv_plain(d1, d2, _build_table_plain(p1, 8),
                      _build_table_plain(p2, 8), True, False)


def glv_windowed_mult_from_points_plain(d1, d2, p1, p2):
    """k1*P1 + k2*P2 from unsigned nibble digits, the function of the
    Pallas `_glv_mega_frompoints_kernel(signed_digits=False,
    n_entries=15)`: d1, d2 int32 [W, B] in [0, 15], most significant first;
    tables [P, .., 15P] per lane (1 doubling + 13 adds); window 0 a select
    (the identity where the digit is 0), no y negation.  Returns canonical
    (x, y, z) planes."""
    return _glv_plain(d1, d2, _build_table_plain(p1, 15),
                      _build_table_plain(p2, 15), False, False)


def _lane_table_entries(table):
    """int32 [E, 3, 16, B] -> [Point per entry]."""
    from .. import point as pt
    return [pt.Point(*table[e].unbind(0)) for e in range(table.shape[0])]


def glv_windowed_mult_plain(d1, d2, t1, t2):
    """k1*P1 + k2*P2 from nibble digits and prebuilt per-lane tables, the
    function of the Pallas `_glv_mega_kernel`: t1, t2 int32 [15, 3, 16, B]
    (entry e = (e + 1) * P); from the identity, 4 doublings and 2 masked
    lookup-adds in every window, window 0 included.  Returns canonical
    (x, y, z) planes."""
    return _glv_plain(d1, d2, _lane_table_entries(t1),
                      _lane_table_entries(t2), False, True)


def _base_accumulate_plain(digits, entry, signed_digits: bool = True):
    """Sum over windows of the selected affine entries, the loop of the
    Pallas `_base_windowed_add_kernel`: window 0 is a select (the whole
    identity where the magnitude is 0, even with the sign bit set); later
    windows are mixed adds, passed through where the magnitude is 0.
    entry(w, mag) -> (x, y) planes of table[w][mag - 1] (anything where mag
    is 0).  Signed digits are magnitude (bits 0-15) | sign << 16, y negated
    here for a set sign bit; unsigned digits are the magnitude."""
    from .. import field as fe
    from .. import point as pt
    f = fe.F_PLAIN
    mag = digits & 0xFFFF if signed_digits else digits
    neg = (digits >> 16) == 1

    def signed_entry(w):
        x, y = entry(w, mag[w])
        if not signed_digits:
            return x, y
        return x, f.select(neg[w], f.neg(y), y)

    x0, y0 = signed_entry(0)
    is0 = mag[0] == 0
    zero = torch.zeros_like(x0)
    one = f.one(zero.shape[1:], zero.device)
    acc = pt.Point(f.select(is0, zero, x0), f.select(is0, one, y0),
                   f.select(is0, zero, one))
    for w in range(1, digits.shape[0]):
        x, y = signed_entry(w)
        acc = pt.select(mag[w] == 0, acc, pt.add_mixed(acc, x, y, f))
    return acc


def base_windowed_add_plain(digits, table, signed_digits: bool = True):
    """k*G = sum over windows of table[w][|d_w| - 1], y negated for negative
    digits: the function of the Pallas `base_windowed_add`
    (`_base_windowed_add_kernel(signed_digits, final_add=False)`).

    digits: int32 [W, B], least significant window first (the digits of a
    secret scalar): magnitude (bits 0-15) | sign << 16 when signed_digits,
    else in [0, E]; table: int32 [W, E, 2, 16] affine multiples of G.  Each
    window's entry is a one-hot masked sum over all E entries
    (`table.lookup_shared_affine`), never an index by the digit.  Returns
    canonical (x, y, z) planes."""
    from .. import table as tbl

    def entry(w, mag):
        return tbl.lookup_shared_affine(table[w], mag)

    acc = _base_accumulate_plain(digits, entry, signed_digits)
    return acc.x, acc.y, acc.z


def base_windowed_add_final_plain(digits, table, qx, qy, qz):
    """(sum over windows of table[w][|d_w| - 1], y negated for negative
    digits) + Q, the function of the Pallas
    `_base_windowed_add_kernel(signed_digits=True, final_add=True)` with
    the per-window selection done by a gather instead of the TPU's one-hot
    matmul (verify's digits are public).

    digits and table as `base_windowed_add_plain`; a complete add of Q ends
    it.  Returns canonical (x, y, z) planes."""
    from .. import field as fe
    from .. import point as pt

    def entry(w, mag):
        ent = table[w].index_select(0, (mag - 1).clamp(min=0).long())
        return ent[:, 0].t().contiguous(), ent[:, 1].t().contiguous()

    acc = _base_accumulate_plain(digits, entry)
    out = pt.add(acc, pt.Point(qx, qy, qz), fe.F_PLAIN)
    return out.x, out.y, out.z


def point_add_plain(x1, y1, z1, x2, y2, z2):
    """(x1, y1, z1) + (x2, y2, z2), RCB Algorithm 7: the composed formula
    of `ops/point.py` under `fe.F_PLAIN`.  Returns canonical planes."""
    from .. import field as fe
    from .. import point as pt
    return tuple(pt.add(pt.Point(x1, y1, z1), pt.Point(x2, y2, z2),
                        fe.F_PLAIN))


def point_double_plain(x, y, z):
    """2 (x, y, z), RCB Algorithm 9, under `fe.F_PLAIN`."""
    from .. import field as fe
    from .. import point as pt
    return tuple(pt.double(pt.Point(x, y, z), fe.F_PLAIN))


def point_double4_plain(x, y, z):
    """16 (x, y, z): four chained doublings (RCB Algorithm 9) under
    `fe.F_PLAIN`, as the Pallas `pdouble4` chains four
    `_point_double_body`."""
    from .. import field as fe
    from .. import point as pt
    p = pt.Point(x, y, z)
    for _ in range(4):
        p = pt.double(p, fe.F_PLAIN)
    return tuple(p)


def point_add_mixed_plain(x1, y1, z1, x2, y2):
    """(x1, y1, z1) + (x2, y2, 1), RCB Algorithm 8 under `fe.F_PLAIN`, the
    function of the Pallas `pmixed`.  The affine addend cannot be the
    identity."""
    from .. import field as fe
    from .. import point as pt
    return tuple(pt.add_mixed(pt.Point(x1, y1, z1), x2, y2, fe.F_PLAIN))


def point_lookup_add_plain(x, y, z, table, digits):
    """The Pallas `plookup_add`: per lane, table[d - 1] selected by a masked
    sum over all 15 entries of the lane's table (int32 [15, 3, 16, B]),
    completely added to (x, y, z); lanes with digit 0 keep (x, y, z)."""
    from .. import field as fe
    from .. import point as pt
    from .. import table as tbl
    acc = pt.Point(x, y, z)
    added = pt.add(acc, tbl.lookup_lane_table(table, digits), fe.F_PLAIN)
    return tuple(c.contiguous() for c in pt.select(digits == 0, acc, added))


def msm_bucket_accumulate_all_plain(digits, px, py, pz, n_buckets: int,
                                    signed_digits: bool = False,
                                    m_slots: int = 1024):
    """Pippenger partial buckets, the function of the Pallas
    `_msm_bucket_all_kernel`: int32 [W, n_buckets, 3, 16, m_slots].

    Slot j of window w sums the points n = j, j + M, ... < N whose digit
    selects the bucket, in increasing n, bucket first in each complete add.
    The walk goes in steps of M points, each step one batched add over all
    [W * M] (window, slot) lanes: the bucket the digit selects (a gather:
    the plain version needs no constant time) plus the point, written back
    where the digit is in [1, n_buckets] and discarded elsewhere.  Signed
    digits are magnitude | sign << 6 with y negated for sign 1.  Lanes past
    N take digit 0."""
    from .. import field as fe
    from .. import point as pt
    f = fe.F_PLAIN
    w, n = digits.shape
    m, nb = m_slots, n_buckets
    dev = digits.device
    ident = pt.identity((w * nb * m,), dev)
    acc = torch.stack(list(ident)).reshape(3, 16, w, nb, m)
    for lo in range(0, n, m):
        k = min(m, n - lo)
        d = torch.zeros((w, m), dtype=torch.int64, device=dev)
        d[:, :k] = digits[:, lo:lo + k]
        pts = torch.zeros((3, 16, m), dtype=lb.DTYPE, device=dev)
        for c, plane in enumerate((px, py, pz)):
            pts[c, :, :k] = plane[:, lo:lo + k]
        pts = pts.unsqueeze(2).expand(3, 16, w, m).reshape(3, 16, w * m)
        mag = d
        y = pts[1]
        if signed_digits:
            mag = d & 0x3F
            y = f.select(((d >> 6) == 1).reshape(-1), f.neg(y), y)
        idx = (mag - 1).clamp(0, nb - 1).reshape(1, 1, w, 1, m)
        idx = idx.expand(3, 16, w, 1, m)
        sel = acc.gather(3, idx).reshape(3, 16, w * m)
        added = pt.add(pt.Point(*sel), pt.Point(pts[0], y, pts[2]), f)
        hit = ((mag >= 1) & (mag <= nb)).reshape(-1)
        new = torch.where(hit, torch.stack(list(added)), sel)
        acc.scatter_(3, idx, new.reshape(3, 16, w, 1, m))
    return acc.permute(2, 3, 0, 1, 4).contiguous()


def msm_fold_plain(window_sums, window_bits: int):
    """sum over windows i of 2^(window_bits * i) W_i by the Horner fold of
    `msm.combine_windows`: from the identity, most significant window
    first, window_bits doublings (RCB Algorithm 9) and one complete add
    (Algorithm 7, the accumulator first) a window, under `fe.F_PLAIN`.
    window_sums: int32 [W, 3, 16] rows.  Returns canonical [16, 1] planes
    (x, y, z)."""
    from .. import field as fe
    from .. import point as pt
    acc = pt.identity((1,), window_sums.device)
    for wsum in window_sums.flip(0):
        for _ in range(window_bits):
            acc = pt.double(acc, fe.F_PLAIN)
        acc = pt.add(acc, pt.Point(*wsum.unsqueeze(-1)), fe.F_PLAIN)
    return tuple(c.contiguous() for c in acc)


# SHA-256 (FIPS 180-4) for RFC 6979's DRBG: round constants, initial hash,
# and the midstates of the all-zero HMAC key (the compressions of 64 bytes
# of 0x36 and of 0x5c), as `csrc/drbg.cuh` has them.
_SHA256_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
_SHA256_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f,
              0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_ZERO_KEY = ((0xf454dead, 0x9725214f, 0x90daf2a0, 0xdf1228ea, 0x64e5750f,
              0xa3924181, 0x824a932b, 0xf8e04e32),
             (0xd385480f, 0x7abb6477, 0x37c9c538, 0x5dd82467, 0x8e043a72,
              0x753434b0, 0xdeb82818, 0x361d45a6))
_M32 = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _sha256_block_plain(st, m):
    """The SHA-256 compression of every lane: st 8 and m 16 words, each an
    int64 [B] tensor (or a python int where it is the same in every lane)
    below 2^32.  Returns the 8 new words."""
    w = list(m)
    a, b, c, d, e, f, g, h = st
    for i in range(64):
        if i >= 16:
            w15, w2 = w[i - 15], w[i - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
        t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) \
            + ((e & f) ^ ((e ^ _M32) & g)) + _SHA256_K[i] + w[i]
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) \
            + ((a & b) ^ (a & c) ^ (b & c))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, \
            (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def _hmac_key_plain(k):
    """The midstates (of K ^ ipad, of K ^ opad) of the 8-word keys k: both
    compressions in one over twice the lanes."""
    lanes = k[0].shape[0]
    pads = [torch.full((lanes,), p, dtype=torch.int64, device=k[0].device)
            for p in (0x36363636, 0x5C5C5C5C)]
    pad = torch.cat(pads)
    both = _sha256_block_plain(
        _SHA256_IV, [torch.cat([w, w]) ^ pad for w in k] + [pad] * 8)
    return [w[:lanes] for w in both], [w[lanes:] for w in both]


def _hmac_plain(key, v, sep=None, data=()):
    """HMAC_K(v), or HMAC_K(v || sep || data) with sep one byte and data
    words, K given by its midstates key = (inner, outer)."""
    if sep is None:
        n_bytes, m = 32, list(v) + [0x80000000]
    else:
        n_bytes, m, prev = 33 + 4 * len(data), list(v), sep
        for w in data:
            m.append(((prev << 24) & _M32) | (w >> 8))
            prev = w
        m.append(((prev << 24) & _M32) | 0x00800000)
    n_words = 16 * ((n_bytes + 9 + 63) // 64)
    m += [0] * (n_words - 1 - len(m)) + [(64 + n_bytes) * 8]
    st = key[0]
    for i in range(0, n_words, 16):
        st = _sha256_block_plain(st, m[i:i + 16])
    return _sha256_block_plain(key[1], st + [0x80000000] + [0] * 6
                               + [(64 + 32) * 8])


def _plane_words(plane):
    """uint8 [32, B] -> 8 int64 [B] big-endian words."""
    b = plane.to(torch.int64).reshape(8, 4, plane.shape[1])
    return list(((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
                 | b[:, 3]).unbind(0))


def rfc6979_nonce_plain(d_plane, e_plane, extra_plane=None,
                        attempt: int = 0):
    """Candidate `attempt` (0 the first) of each lane's RFC 6979 HMAC-SHA256
    DRBG (3.2 steps b-h, then h.3 and h.1-2 a further candidate) seeded with
    key || e || extra, in PyTorch integer ops over lanes: the function of
    `csrc/drbg.cu` `k_rfc6979`, with the same midstates.  d_plane, e_plane
    (the digests reduced mod n) and extra_plane (RFC 6979 3.6 additional
    data, or None): uint8 [32, B].  Returns the candidates, uint8 [32, B]:
    what `native.rfc6979_nonce_batch` returns, then `attempt` calls of
    `native.rfc6979_continue`."""
    data = _plane_words(d_plane) + _plane_words(e_plane)
    if extra_plane is not None:
        data += _plane_words(extra_plane)
    key, v = _ZERO_KEY, [0x01010101] * 8
    for sep in (0, 1):                      # steps d-e, then f-g
        key = _hmac_key_plain(_hmac_plain(key, v, sep, data))
        v = _hmac_plain(key, v)
    for _ in range(attempt):                # h.2, then h.3
        v = _hmac_plain(key, v)
        key = _hmac_key_plain(_hmac_plain(key, v, 0))
        v = _hmac_plain(key, v)
    t = torch.stack(_hmac_plain(key, v))    # h.2: the candidate
    return torch.stack([(t >> s) & 0xFF for s in (24, 16, 8, 0)],
                       1).reshape(32, d_plane.shape[1]).to(torch.uint8)


# BIP-0340's challenge tag, whose tagged hash `bip340_challenge` computes.
BIP340_CHALLENGE_TAG = b"BIP0340/challenge"


def bip340_challenge_plain(r_plane, px_plane, m_plane):
    """Each lane's BIP-0340 challenge digest SHA256(t || t || r || px || m),
    t = SHA256("BIP0340/challenge"), big-endian and not reduced: the
    function of `csrc/bip340.cu` `k_bip340_challenge`, the rows hashed by
    the native library's `tagged_hash_batch` on the host.  r_plane,
    px_plane: uint8 [32, B]; m_plane: uint8 [L, B].  Returns uint8 [32, B]
    on the planes' device."""
    rows = [p.T.contiguous().cpu().numpy()
            for p in (r_plane, px_plane, m_plane)]
    out = native.tagged_hash_batch(BIP340_CHALLENGE_TAG, *rows,
                                   r_plane.shape[1])
    return torch.from_numpy(out.T.copy()).to(r_plane.device)


# The bytes of one field element's uniform string in the hash-to-curve
# suites (RFC 9380's L for secp256k1): the rows of `expand_xmd`'s planes.
XMD_PART = 48


def expand_xmd_plain(rows, lens, dst_prime: bytes, n_out: int, lanes: int):
    """RFC 9380 expand_message_xmd with SHA-256 of each lane's message, as
    byte planes: the function of `csrc/xmd.cu` `k_expand_xmd`, by the host
    path `h2c.expand_message_xmd_batch` (one native SHA-256 call a stage,
    counted in `h2c.XMD_HOST_BLOCKS`).  rows: uint8 [n, W], lane i's
    message the first lens[i] bytes of row i; lens: int32 [n]; dst_prime:
    DST' = DST || I2OSP(len(DST), 1).  Returns uint8 [48, n_out // 48 *
    lanes] on the rows' device: byte j of lane i's string at row j % 48,
    column (j // 48) lanes + i; lanes past n repeat lane n - 1."""
    from ...models import h2c
    uniform = h2c.expand_message_xmd_batch(
        rows.cpu().numpy(), dst_prime[:-1], n_out, lens.cpu().numpy())
    return torch.cat([bt.byte_plane_np(np.ascontiguousarray(
        uniform[:, lo:lo + XMD_PART]), lanes, rows.device)
        for lo in range(0, n_out, XMD_PART)], 1)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def mod_mul(a: torch.Tensor, b: torch.Tensor, modulus: int) -> torch.Tensor:
    """a * b mod m.  Replaces Pallas `mod_mul` (kernels.py:1366)."""
    if _on_cpu(a, b):
        PLAIN_CALLS["mod_mul"] += 1
        return mod_mul_plain(a, b, modulus)
    lanes = a.shape[1]
    _check("mod_mul", a, 16, lanes)
    _check("mod_mul", b, 16, lanes)
    out = torch.empty_like(a)
    _launch("mod_mul", "modops", "mod_mul", [a, b, out],
            [lanes, MOD_ID[modulus]], (lanes, None))
    return out


def mod_square(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """a^2 mod m.  Replaces Pallas `mod_square` (kernels.py:1371)."""
    if _on_cpu(a):
        PLAIN_CALLS["mod_square"] += 1
        return mod_square_plain(a, modulus)
    lanes = a.shape[1]
    _check("mod_square", a, 16, lanes)
    out = torch.empty_like(a)
    _launch("mod_square", "modops", "mod_square", [a, out],
            [lanes, MOD_ID[modulus]], (lanes, None))
    return out


def _pow_chain_launch(name: str, a: torch.Tensor, e: int, modulus: int,
                      detail: int) -> torch.Tensor:
    """a^e mod m by one launch of the chain kernel, counted under `name`
    with `detail` in SHAPES."""
    lanes = a.shape[1]
    _check(name, a, 16, lanes)
    out = torch.empty_like(a)
    if lanes:
        words = _pow_chain_words(e)
        _launch(name, "modops", "mod_pow_chain", [a, out, words],
                [lanes, words.numel(), MOD_ID[modulus]], (lanes, detail))
    return out


def mod_pow2k(a: torch.Tensor, k: int, modulus: int) -> torch.Tensor:
    """a^(2^k) mod m, k squarings in one launch: the one-step chain of
    `mod_pow_chain`'s kernel.  Replaces Pallas `mod_pow2k`
    (kernels.py:784)."""
    if not 1 <= k < 1 << 12:
        raise ValueError(f"mod_pow2k: k must be in [1, 4096), got {k}")
    if _on_cpu(a):
        PLAIN_CALLS["mod_pow2k"] += 1
        return mod_pow2k_plain(a, k, modulus)
    return _pow_chain_launch("mod_pow2k", a, 1 << k, modulus, k)


def mod_pow_chain(a: torch.Tensor, e: int, modulus: int) -> torch.Tensor:
    """a^e mod m for a public constant e >= 1, the whole chain in one
    launch (`pow_chain_steps(e)`: its squarings and multiplies, no address
    or trip count depending on a).  Replaces the chain of Pallas `mod_pow2k`
    (kernels.py:784) and `mod_mul` (:1366) calls of the JAX
    `ModRing.pow_const_chain` (modring.py:204)."""
    if _on_cpu(a):
        PLAIN_CALLS["mod_pow_chain"] += 1
        return mod_pow_chain_plain(a, e, modulus)
    return _pow_chain_launch("mod_pow_chain", a, e, modulus, e)


def glv_windowed_mult_signed_from_points(d1, d2, p1, p2):
    """k1*P1 + k2*P2, one launch.  Replaces Pallas
    `glv_windowed_mult_signed_from_points` (kernels.py:1135)."""
    planes = list(p1) + list(p2)
    if _on_cpu(d1, d2, *planes):
        PLAIN_CALLS["glv_windowed_mult_signed_from_points"] += 1
        return glv_windowed_mult_signed_from_points_plain(d1, d2, p1, p2)
    name = "glv_windowed_mult_signed_from_points"
    w, lanes = d1.shape
    _check(name, d1, w, lanes)
    _check(name, d2, w, lanes)
    for t in planes:
        _check(name, t, 16, lanes)
    outs = [torch.empty_like(planes[0]) for _ in range(3)]
    _launch(name, "glv", "glv_windowed_mult_signed",
            [d1, d2, *planes, *outs], [lanes, w])
    return tuple(outs)


def _check_table(name: str, table: torch.Tensor, w: int) -> None:
    if table.dtype != torch.int32 or table.dim() != 4 \
            or table.shape[0] != w or table.shape[2:] != (2, 16) \
            or not table.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 "
                         f"[{w}, E, 2, 16] table, got {table.dtype} "
                         f"{tuple(table.shape)}")


def _check_packed(name: str, t: torch.Tensor, dtype, shape,
                  device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         f"{dtype} {tuple(shape)} packed table on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def base_windowed_add(digits, table, signed_digits: bool = True):
    """k*G from secret digits, one launch.  Replaces Pallas
    `base_windowed_add` (kernels.py:1041) in both digit modes.  The kernel
    reads the table packed as uint8 [W, 64, E_pad] (`table.packed_of`, the
    cached copy for a `table.base_table`) and selects each window's entry
    by an int8 tensor-core product of one-hot rows with every entry, so no
    address or trip count depends on a digit.  Any entry count from 1 to
    2^14."""
    from .. import table as tbl
    name = "base_windowed_add"
    if _on_cpu(digits, table):
        PLAIN_CALLS[name] += 1
        return base_windowed_add_plain(digits, table, signed_digits)
    w, lanes = digits.shape
    _check(name, digits, w, lanes)
    _check_table(name, table, w)
    n_entries = table.shape[1]
    if not 1 <= n_entries <= 1 << 14:
        raise ValueError(f"{name}: the kernel selects from 1 to 2^14 "
                         f"entries a window, got {n_entries}")
    table_bytes = tbl.packed_of(table, "bytes")
    e_pad = table_bytes.shape[2]
    _check_packed(name, table_bytes, torch.uint8, (w, 64, e_pad),
                  digits.device)
    outs = [torch.empty((16, lanes), dtype=torch.int32, device=digits.device)
            for _ in range(3)]
    _launch(name, "base", "base_windowed_add", [digits, table_bytes, *outs],
            [lanes, w, e_pad, int(signed_digits)])
    return tuple(outs)


def base_windowed_add_final(digits, table, qx, qy, qz):
    """u1*G + Q, one launch.  Replaces Pallas `base_windowed_add_final`
    (kernels.py:1070).  The kernel gathers each window's entry (public
    digits) a window ahead from the table packed as int32 [W, E, 16] words
    (`table.packed_of`, the cached copy for a `table.base_table`)."""
    from .. import table as tbl
    if _on_cpu(digits, table, qx, qy, qz):
        PLAIN_CALLS["base_windowed_add_final"] += 1
        return base_windowed_add_final_plain(digits, table, qx, qy, qz)
    name = "base_windowed_add_final"
    w, lanes = digits.shape
    _check(name, digits, w, lanes)
    _check_table(name, table, w)
    for t in (qx, qy, qz):
        _check(name, t, 16, lanes)
    table_words = tbl.packed_of(table, "words")
    _check_packed(name, table_words, torch.int32, (w, table.shape[1], 16),
                  digits.device)
    outs = [torch.empty_like(qx) for _ in range(3)]
    _launch(name, "base", "base_windowed_add_final",
            [digits, table_words, qx, qy, qz, *outs],
            [lanes, w, table.shape[1]])
    return tuple(outs)


def blocks_per_sm(lib_name: str, fn_name: str, which: int = 0) -> int:
    """Resident blocks an SM of a kernel, as the CUDA occupancy calculator
    gives them through lib<lib_name>.so's `fn_name(which)` (the kernels are
    built first where needed): `base_blocks_per_sm` (0 `k_base_scan`, 1
    `k_base_final`), `point_add_blocks_per_sm`, `pow_chain_blocks_per_sm`
    (0 mod p, 1 mod n)."""
    fn = getattr(build.library(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    blocks = fn(int(which))
    if blocks < 0:
        raise RuntimeError(f"{fn_name}: the CUDA occupancy query failed")
    return blocks


def _lanewise(name: str, lib_name: str, plain, planes, extra=(),
              check=None):
    """The one-thread-a-lane point wrappers: `planes` int32 [16, B] and
    `extra` operands (checked by `check(B)`) in, three [16, B] planes out,
    one launch of `lib_name`'s `name` at any width B; CPU tensors take
    `plain` instead."""
    on_cpu = _on_cpu(*planes, *extra)
    lanes = planes[0].shape[1] if planes[0].dim() == 2 else -1
    for t in planes:
        _check(name, t, 16, lanes)
    if check is not None:
        check(lanes)
    outs = [torch.empty_like(planes[0]) for _ in range(3)]
    if not lanes:               # an empty batch: nothing to compute
        return tuple(outs)
    if on_cpu:
        PLAIN_CALLS[name] += 1
        return plain(*planes, *extra)
    _launch(name, lib_name, name, [*planes, *extra, *outs], [lanes],
            (lanes, None))
    return tuple(outs)


def point_add(x1, y1, z1, x2, y2, z2):
    """(x1, y1, z1) + (x2, y2, z2) lane by lane, one launch, any width B.
    Replaces Pallas `point_add` (kernels.py:1376)."""
    return _lanewise("point_add", "point", point_add_plain,
                     (x1, y1, z1, x2, y2, z2))


def point_double(x, y, z):
    """2 (x, y, z) lane by lane, one launch, any width B.  Replaces Pallas
    `point_double` (kernels.py:1380)."""
    return _lanewise("point_double", "point", point_double_plain, (x, y, z))


def msm_bucket_accumulate_all(digits, px, py, pz, n_buckets: int,
                              signed_digits: bool = False,
                              m_slots: int = 1024):
    """Pippenger partial buckets of every window in one launch: int32
    [W, n_buckets, 3, 16, m_slots] (see `msm_bucket_accumulate_all_plain`
    for the function).  digits int32 [W, N]; px, py, pz int32 [16, N]; any
    N.  Replaces Pallas `msm_bucket_accumulate_all` (kernels.py:1232).

    The kernel addresses a bucket by its digit (MSM's scalars are public;
    see `csrc/msm.cu`) and keeps the buckets in a device-memory scratch
    buffer of W * m_slots * n_buckets * 96 bytes, allocated here."""
    name = "msm_bucket_accumulate_all"
    on_cpu = _on_cpu(digits, px, py, pz)
    if digits.dim() != 2:
        raise ValueError(f"{name}: digits must be [W, N], got "
                         f"{tuple(digits.shape)}")
    w, n = digits.shape
    _check(name, digits, w, n)
    for t in (px, py, pz):
        _check(name, t, 16, n)
    if m_slots < 1 or n_buckets < 1:
        raise ValueError(f"{name}: need m_slots >= 1 and n_buckets >= 1, got "
                         f"{m_slots}, {n_buckets}")
    if on_cpu:
        PLAIN_CALLS[name] += 1
        return msm_bucket_accumulate_all_plain(digits, px, py, pz, n_buckets,
                                               signed_digits, m_slots)
    out = torch.empty((w, n_buckets, 3, 16, m_slots), dtype=torch.int32,
                      device=digits.device)
    scratch = torch.empty((w * m_slots * n_buckets * 24,), dtype=torch.int32,
                          device=digits.device)
    _launch(name, "msm", "msm_bucket_accumulate_all",
            [digits, px, py, pz, scratch, out],
            [w, n, n_buckets, int(signed_digits), m_slots])
    return out


def msm_fold(window_sums: torch.Tensor, window_bits: int):
    """The Horner fold of `msm.combine_windows` in one launch of one warp
    (see `msm_fold_plain` for the function): window_sums int32 [W, 3, 16]
    rows, any W >= 0 and window_bits >= 1.  Returns (x, y, z) int32
    [16, 1] planes.  Replaces the fold of the JAX `combine_windows`
    (msm.py:297): window_bits Pallas `point_double` (kernels.py:1380) and
    one `point_add` (:1376) a window."""
    name = "msm_fold"
    if window_sums.dtype != torch.int32 or window_sums.dim() != 3 \
            or window_sums.shape[1:] != (3, 16) \
            or not window_sums.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 [W, 3, 16] "
                         f"window sums, got {window_sums.dtype} "
                         f"{tuple(window_sums.shape)}")
    if window_bits < 1:
        raise ValueError(f"{name}: window_bits must be >= 1, got "
                         f"{window_bits}")
    if _on_cpu(window_sums):
        PLAIN_CALLS[name] += 1
        return msm_fold_plain(window_sums, window_bits)
    n_windows = window_sums.shape[0]
    outs = [torch.empty((16, 1), dtype=torch.int32,
                        device=window_sums.device) for _ in range(3)]
    _launch(name, "msm", "msm_fold", [window_sums, *outs],
            [n_windows, window_bits], (n_windows, window_bits))
    return tuple(outs)


def glv_windowed_mult_from_points(d1, d2, p1, p2):
    """k1*P1 + k2*P2 from unsigned nibble digits [W, B], one launch; the
    15-entry tables are built per lane in the kernel.  Replaces Pallas
    `glv_windowed_mult_from_points` (kernels.py:1105)."""
    name = "glv_windowed_mult_from_points"
    planes = list(p1) + list(p2)
    if _on_cpu(d1, d2, *planes):
        PLAIN_CALLS[name] += 1
        return glv_windowed_mult_from_points_plain(d1, d2, p1, p2)
    w, lanes = d1.shape
    _check(name, d1, w, lanes)
    _check(name, d2, w, lanes)
    for t in planes:
        _check(name, t, 16, lanes)
    outs = [torch.empty_like(planes[0]) for _ in range(3)]
    _launch(name, "glv", "glv_windowed_mult_unsigned",
            [d1, d2, *planes, *outs], [lanes, w])
    return tuple(outs)


def _check_lane_table(name: str, t: torch.Tensor, lanes: int) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (15, 3, 16, lanes) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 "
                         f"[15, 3, 16, {lanes}] lane table, got {t.dtype} "
                         f"{tuple(t.shape)}")


def glv_windowed_mult(d1, d2, t1, t2):
    """k1*P1 + k2*P2 from nibble digits [W, B] and two prebuilt lane tables
    [15, 3, 16, B], one launch, from the identity.  Replaces Pallas
    `glv_windowed_mult` (kernels.py:1266)."""
    name = "glv_windowed_mult"
    if _on_cpu(d1, d2, t1, t2):
        PLAIN_CALLS[name] += 1
        return glv_windowed_mult_plain(d1, d2, t1, t2)
    w, lanes = d1.shape
    _check(name, d1, w, lanes)
    _check(name, d2, w, lanes)
    _check_lane_table(name, t1, lanes)
    _check_lane_table(name, t2, lanes)
    outs = [torch.empty((16, lanes), dtype=torch.int32, device=d1.device)
            for _ in range(3)]
    _launch(name, "glv", "glv_windowed_mult_tables", [d1, d2, t1, t2, *outs],
            [lanes, w])
    return tuple(outs)


def point_double4(x, y, z):
    """16 (x, y, z) lane by lane, one launch, any width B.  Replaces Pallas
    `point_double4` (kernels.py:1384)."""
    return _lanewise("point_double4", "point", point_double4_plain,
                     (x, y, z))


def point_add_mixed(x1, y1, z1, x2, y2):
    """(x1, y1, z1) + (x2, y2, 1) lane by lane, one launch, any width B.
    Replaces Pallas `point_add_mixed` (kernels.py:1413)."""
    return _lanewise("point_add_mixed", "point", point_add_mixed_plain,
                     (x1, y1, z1, x2, y2))


def point_lookup_add(x, y, z, table, digits):
    """The GLV window body after the doublings, one launch: per lane the
    masked select of table[d - 1] (every entry read), a complete add into
    (x, y, z), digit 0 passed through.  table int32 [15, 3, 16, B], digits
    int32 [B] in [0, 15].  Replaces Pallas `point_lookup_add`
    (kernels.py:1388)."""
    name = "point_lookup_add"

    def check(lanes):
        _check_lane_table(name, table, lanes)
        if digits.dtype != torch.int32 or tuple(digits.shape) != (lanes,) \
                or not digits.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 [{lanes}] "
                             f"digits, got {digits.dtype} "
                             f"{tuple(digits.shape)}")
    return _lanewise(name, "lookup", point_lookup_add_plain, (x, y, z),
                     (table, digits), check)


def rfc6979_nonce(d_plane, e_plane, extra_plane=None, attempt: int = 0):
    """Candidate `attempt` of each lane's RFC 6979 DRBG (see
    `rfc6979_nonce_plain` for the function), one launch of `k_rfc6979`
    (`csrc/drbg.cu`, one thread a lane): d_plane, e_plane and extra_plane
    (or None) uint8 [32, B], attempt >= 0.  Returns uint8 [32, B].
    Replaces no TPU kernel: the JAX package runs this DRBG on its host."""
    name = "rfc6979_nonce"
    planes = [d_plane, e_plane] + ([] if extra_plane is None
                                   else [extra_plane])
    on_cpu = _on_cpu(*planes)
    lanes = d_plane.shape[1] if d_plane.dim() == 2 else -1
    for t in planes:
        _check(name, t, 32, lanes, torch.uint8)
    if attempt < 0:
        raise ValueError(f"{name}: attempt must be >= 0, got {attempt}")
    if on_cpu:
        PLAIN_CALLS[name] += 1
        return rfc6979_nonce_plain(d_plane, e_plane, extra_plane, attempt)
    out = torch.empty_like(d_plane)
    if lanes:
        _launch(name, "drbg", "rfc6979_nonce",
                [d_plane, e_plane, planes[-1], out],
                [lanes, attempt, int(extra_plane is not None)],
                (lanes, attempt))
    return out


def bip340_challenge(r_plane, px_plane, m_plane):
    """Each lane's BIP-0340 challenge digest (see `bip340_challenge_plain`
    for the function), one launch of `k_bip340_challenge` (`csrc/bip340.cu`,
    one thread a lane): r_plane and px_plane uint8 [32, B], m_plane uint8
    [L, B], any L.  Returns uint8 [32, B].  Replaces no TPU kernel: the JAX
    package hashes the challenge on its host."""
    name = "bip340_challenge"
    on_cpu = _on_cpu(r_plane, px_plane, m_plane)
    lanes = r_plane.shape[1] if r_plane.dim() == 2 else -1
    _check(name, r_plane, 32, lanes, torch.uint8)
    _check(name, px_plane, 32, lanes, torch.uint8)
    length = m_plane.shape[0] if m_plane.dim() == 2 else -1
    _check(name, m_plane, length, lanes, torch.uint8)
    if on_cpu:
        PLAIN_CALLS[name] += 1
        return bip340_challenge_plain(r_plane, px_plane, m_plane)
    out = torch.empty_like(r_plane)
    if lanes:
        _launch(name, "bip340", "bip340_challenge",
                [r_plane, px_plane, m_plane, out], [lanes, length],
                (lanes, length))
    return out


def expand_xmd(rows, lens, dst_prime: bytes, n_out: int, lanes: int):
    """Each lane's RFC 9380 expand_message_xmd (see `expand_xmd_plain` for
    the function and the layout), one launch of `k_expand_xmd`
    (`csrc/xmd.cu`, one thread a lane): rows uint8 [n, W] and lens int32
    [n], 1 <= n <= lanes, lengths in [0, W] (the caller checks them; the
    kernel clamps); dst_prime 2 to 256 bytes ending in its DST's length;
    n_out a multiple of 48 up to 8,160.  Returns uint8 [48, n_out // 48 *
    lanes].  Replaces no TPU kernel: the JAX package expands on its
    host."""
    name = "expand_xmd"
    on_cpu = _on_cpu(rows, lens)
    if rows.dtype != torch.uint8 or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise ValueError(f"{name}: expected contiguous uint8 [n, W] rows, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    n, width = rows.shape
    if lens.dtype != torch.int32 or tuple(lens.shape) != (n,) \
            or not lens.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 [{n}] lengths, "
                         f"got {lens.dtype} {tuple(lens.shape)}")
    if not 1 <= n <= lanes:
        raise ValueError(f"{name}: {n} messages for {lanes} lanes")
    if not 2 <= len(dst_prime) <= 256 \
            or dst_prime[-1] != len(dst_prime) - 1:
        raise ValueError(f"{name}: DST' must be 2 to 256 bytes, its last "
                         f"the DST's length")
    if n_out % XMD_PART or not XMD_PART <= n_out <= 255 * 32:
        raise ValueError(f"{name}: n_out must be a multiple of {XMD_PART} "
                         f"up to {255 * 32}, got {n_out}")
    if on_cpu:
        PLAIN_CALLS[name] += 1
        return expand_xmd_plain(rows, lens, dst_prime, n_out, lanes)
    out = torch.empty((XMD_PART, n_out // XMD_PART * lanes),
                      dtype=torch.uint8, device=rows.device)
    dst = torch.frombuffer(bytearray(dst_prime), dtype=torch.uint8)
    _launch(name, "xmd", "expand_xmd", [rows, lens, dst, out],
            [len(dst_prime), n, width, lanes, n_out], (lanes, width))
    return out
