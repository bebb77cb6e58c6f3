"""Branch-free multi-limb (bignum) arithmetic on limb planes, in PyTorch.

A 256-bit quantity is a *limb plane*: a tensor of shape ``[L, *batch]``
holding ``L`` little-endian limbs of 16 bits each, the layout of
`secp256k1_tpu.ops.limbs`.  Canonical planes are stored as ``int32``
(`DTYPE`); every function here widens to ``int64`` (`WIDE`) because CPU
PyTorch has no unsigned 32-bit add, shift or compare, and returns ``int64``.

Carries are resolved without a sequential scan over the limb axis: a few
rounds of "keep the low 16 bits, move the rest up one limb" leave every limb
in [0, 2^16], and the remaining 0/1 carries are a carry-lookahead over
per-limb generate/propagate bits, computed as one integer addition on bit
masks (`_resolve_unit_carries`).  The same trick resolves borrow chains.  So
each primitive is a fixed, small number of tensor ops whatever the width.

This is the plain PyTorch path: the port's CPU path and the reference that
the CUDA kernels of `ops/cuda` are held against.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = 0xFFFF
NLIMBS = 256 // LIMB_BITS  # 16
DTYPE = torch.int32        # storage type of a plane
WIDE = torch.int64         # working type of the limb algebra


# ---------------------------------------------------------------------------
# Host-side conversions (numpy / python int) -- constants and tests.
# ---------------------------------------------------------------------------

def int_to_limbs(v: int, n_limbs: int = NLIMBS) -> np.ndarray:
    """Python int -> little-endian 16-bit limbs, shape [n_limbs], int64."""
    if v < 0:
        raise ValueError("negative")
    out = np.zeros((n_limbs,), dtype=np.int64)
    for i in range(n_limbs):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    if v != 0:
        raise ValueError("value does not fit in n_limbs")
    return out


def limbs_to_int(x) -> int:
    """Little-endian limb vector [L] -> python int."""
    x = np.asarray(x)
    assert x.ndim == 1
    v = 0
    for i in range(x.shape[0] - 1, -1, -1):
        v = (v << LIMB_BITS) | int(x[i])
    return v


def int_to_limbs_batch(vals, n_limbs: int = NLIMBS) -> np.ndarray:
    """List of ints -> [n_limbs, B] int64 limb plane."""
    return np.stack([int_to_limbs(v, n_limbs) for v in vals], axis=-1)


def limbs_to_int_batch(x) -> list:
    """[L, B] limb plane (numpy or tensor) -> list of python ints."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    assert x.ndim == 2
    return [limbs_to_int(x[:, i]) for i in range(x.shape[1])]


# ---------------------------------------------------------------------------
# Small helpers.
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def const_plane(limbs, like: torch.Tensor) -> torch.Tensor:
    """Constant limb vector as an int64 [L, 1, ...] tensor on like's device,
    shaped to broadcast against `like` ([L', *batch])."""
    arr = np.asarray(limbs, dtype=np.int64)
    key = (arr.tobytes(), str(like.device), like.ndim)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(arr, dtype=WIDE, device=like.device)
        t = t.reshape((arr.shape[0],) + (1,) * (like.ndim - 1))
        _CONST_CACHE[key] = t
    return t


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    key = ("arange", n, str(like.device), like.ndim)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.arange(n, dtype=WIDE, device=like.device)
        t = t.reshape((n,) + (1,) * (like.ndim - 1))
        _CONST_CACHE[key] = t
    return t


def _w(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == WIDE else x.to(WIDE)


def pad_limbs(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad the limb axis (dim 0)."""
    if before == 0 and after == 0:
        return x
    out = x.new_zeros((x.shape[0] + before + after,) + tuple(x.shape[1:]))
    out[before:before + x.shape[0]] = x
    return out


CHAIN_BITS = 62          # windows a carry-chain word holds (a + g + 1 < 2^63)


def _bit_mask(flags: torch.Tensor) -> torch.Tensor:
    """[W, *batch] 0/1 int64 -> [*batch] int64 with bit i = flags[i]."""
    w = flags.shape[0]
    return (flags << _arange(w, flags)).sum(0)


def _mask_bits(mask: torch.Tensor, w: int) -> torch.Tensor:
    """[*batch] int64 bit mask -> [w, *batch] 0/1 int64."""
    return (mask.unsqueeze(0) >> _arange(w, mask.unsqueeze(0))) & 1


def carry_chain(gen: torch.Tensor, prop: torch.Tensor):
    """Carry-lookahead over the limb axis: gen/prop [W, *batch] 0/1 int64
    (never both set).  Returns (carry_in [W, *batch], carry_out [*batch]):
    carry_in[i] = gen[i-1] | (prop[i-1] & carry_in[i-1]).  Computed as the
    carries of the binary sum (gen|prop) + gen + c, whose per-bit generate
    and propagate are exactly gen and prop, over words of at most
    CHAIN_BITS windows, each word's carry out the next one's carry in (the
    signed 4-bit fixed-base windows need 64)."""
    w = gen.shape[0]
    carries, c_in = [], 0
    for lo in range(0, w, CHAIN_BITS):
        k = min(CHAIN_BITS, w - lo)
        g = _bit_mask(gen[lo:lo + k])
        a = g | _bit_mask(prop[lo:lo + k])
        s = a + g + c_in if lo else a + g
        carries.append(_mask_bits(s ^ a ^ g, k))
        c_in = (s >> k) & 1
    return (carries[0] if len(carries) == 1 else torch.cat(carries, 0)), c_in


# ---------------------------------------------------------------------------
# Device-side primitives (tensor in, int64 tensor out, batch-agnostic).
# ---------------------------------------------------------------------------

def carry_prop(x: torch.Tensor, out_limbs: int | None = None,
               bits: int = 32) -> torch.Tensor:
    """Propagate carries so every limb < 2^16.

    `x`: [K, *batch] non-negative limbs, each < 2^bits (bits <= 62).
    Returns [out_limbs, *batch] (default K + 1): the value mod
    2^(16 * out_limbs), as `secp256k1_tpu.ops.limbs.carry_prop` returns it.
    """
    x = _w(x)
    k = x.shape[0]
    if out_limbs is None:
        out_limbs = k + 1
    assert 17 <= bits <= 62 or bits <= 16
    if bits <= 16:
        return pad_limbs(x, 0, max(0, out_limbs - k))[:out_limbs]
    reach = -(-(bits + 1) // LIMB_BITS)       # limbs a carry can climb
    x = pad_limbs(x, 0, max(k + reach, out_limbs) - k)
    _carry_rounds(x, bits)
    return _resolve_unit_carries(x)[:out_limbs]


def _carry_rounds(x: torch.Tensor, bits: int) -> None:
    """In place: limbs each < 2^bits -> limbs in [0, 2^16], same value.
    Each round moves the bits above 16 one limb up, so a limb bounded by
    2^b ends bounded by 2^16 + 2^(b-16).  The top limb must have room."""
    rounds = 1 + max(0, -(-(bits - 17) // 15))
    for _ in range(rounds):
        hi = x >> LIMB_BITS
        x &= LIMB_MASK
        x[1:] += hi[:-1]


def _resolve_unit_carries(x: torch.Tensor) -> torch.Tensor:
    """Limbs in [0, 2^16] -> limbs in [0, 2^16) (final carry dropped)."""
    gen = x >> LIMB_BITS                      # limb == 2^16
    prop = (x == LIMB_MASK).to(WIDE)          # limb == 2^16 - 1
    cin, _ = carry_chain(gen, prop)
    return (x + cin) & LIMB_MASK


def add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb-wise add without carry propagation (widths may differ)."""
    a, b = _w(a), _w(b)
    la, lb_ = a.shape[0], b.shape[0]
    if la < lb_:
        a = pad_limbs(a, 0, lb_ - la)
    elif lb_ < la:
        b = pad_limbs(b, 0, la - lb_)
    return a + b


def add(a: torch.Tensor, b: torch.Tensor,
        out_limbs: int | None = None) -> torch.Tensor:
    """Full add with carry propagation. Default out width max(La,Lb)+1."""
    if out_limbs is None:
        out_limbs = max(a.shape[0], b.shape[0]) + 1
    return carry_prop(add_raw(a, b), out_limbs, bits=17)


def product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[La, *B] x [Lb, *B] (limbs < 2^16) -> [La+Lb-1, *B] column sums of
    the schoolbook product, by the skew trick: row i of the [La, Lb]
    partial products is shifted by i limbs through a reshape."""
    a, b = _w(a), _w(b)
    la, lb_ = a.shape[0], b.shape[0]
    batch = tuple(max(x, y) for x, y in zip(a.shape[1:], b.shape[1:]))
    wd = la + lb_
    q = a.new_zeros((la, wd) + tuple(batch))            # [La, wd, *B]
    torch.mul(a.unsqueeze(1), b.unsqueeze(0), out=q[:, :lb_])
    q = q.view((la * wd,) + tuple(batch))[:la * (wd - 1)]
    return q.view((la, wd - 1) + tuple(batch)).sum(0)


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product: [La,*B] x [Lb,*B] -> [La+Lb,*B], limbs < 2^16."""
    la, lb_ = a.shape[0], b.shape[0]
    cols = product_columns(a, b)
    bits = 32 + max(1, min(la, lb_)).bit_length()
    return carry_prop(cols, la + lb_, bits=bits)


def square_wide(a: torch.Tensor) -> torch.Tensor:
    return mul_wide(a, a)


def mul_word(a: torch.Tensor, w: int) -> torch.Tensor:
    """Multiply by a small constant word (w < 2^15), e.g. b3 = 21."""
    assert 0 <= w < (1 << 15)
    return carry_prop(_w(a) * w, a.shape[0] + 1, bits=31)


def mul_const(a: torch.Tensor, c_limbs) -> torch.Tensor:
    """Multiply [La,*B] by a constant given as 16-bit limbs -> [La+Lc,*B]."""
    c = const_plane(c_limbs, a)
    la, lc = a.shape[0], c.shape[0]
    cols = product_columns(a, c)
    return carry_prop(cols, la + lc, bits=32 + min(la, lc).bit_length())


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b with borrow chain.  Returns (diff [L,*B] int64, borrow [*B]
    int64, 1 where a < b).  Widths may differ (zero-extended)."""
    a, b = _w(a), _w(b)
    la, lb_ = a.shape[0], b.shape[0]
    width = max(la, lb_)
    a = pad_limbs(a, 0, width - la)
    b = pad_limbs(b, 0, width - lb_)
    d = a - b                                 # (-2^16, 2^16)
    gen = (d < 0).to(WIDE)
    prop = (d == 0).to(WIDE)
    bin_, bout = carry_chain(gen, prop)
    b_next = torch.cat([bin_[1:], bout.unsqueeze(0)], 0)
    return d - bin_ + (b_next << LIMB_BITS), bout


def cond_sub(x: torch.Tensor, m_limbs) -> torch.Tensor:
    """Subtract constant m once if x >= m (branchless)."""
    m = np.asarray(m_limbs)
    assert m.shape[0] == x.shape[0]
    d, borrow = sub_borrow(x, const_plane(m, x))
    return torch.where((borrow != 0).unsqueeze(0), _w(x), d)


def geq_const(x: torch.Tensor, m_limbs) -> torch.Tensor:
    """x >= m (constant), branchless.  Returns bool [*batch]."""
    _, borrow = sub_borrow(x, const_plane(m_limbs, x))
    return borrow == 0


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-lane select: mask [*batch] bool -> a where True else b."""
    return torch.where(mask.unsqueeze(0), a, b)


def mod_fold(wide: torch.Tensor, c_limbs) -> torch.Tensor:
    """Reduce `wide` ([W <= 32, *B], limbs < 2^16) mod m = 2^256 - c by
    Solinas folding (2^256 = c), to the canonical [16, *B] residue, as
    `secp256k1_tpu.ops.limbs.mod_fold` does.

    The folds `lo + hi*c` leave limbs only bounded by 2^16 (carry rounds,
    no exact carry resolution); the one exact normalization comes last,
    when the value is below 2m, before one conditional subtract of m."""
    c_arr = np.asarray(c_limbs, dtype=np.int64)
    c = const_plane(c_arr, wide)
    lc = c.shape[0]
    cbits = limbs_to_int(c_arr).bit_length()
    x = _w(wide)
    bits, vbits = 16, LIMB_BITS * x.shape[0]
    while -(-vbits // LIMB_BITS) > NLIMBS + 1:
        lo, hi = x[:NLIMBS], x[NLIMBS:]
        prod = product_columns(hi, c)
        pbits = max(bits + 16 + min(hi.shape[0], lc).bit_length(), 17) + 1
        vbits = max(257, vbits - 256 + cbits) + 1
        width = max(NLIMBS, prod.shape[0]) + -(-(pbits + 1) // LIMB_BITS)
        y = x.new_zeros((width,) + tuple(x.shape[1:]))
        y[:prod.shape[0]] = prod
        y[:NLIMBS] += lo
        _carry_rounds(y, pbits)
        x, bits = y[:-(-vbits // LIMB_BITS)], 17
    # Limbs <= 2^16, at most 17 of them: fold limb 16 once more.  The low
    # part is < 2^256 + 2^241 and x16 * c < 2^145, so the value is < 2m.
    y = x.new_zeros((NLIMBS + 3,) + tuple(x.shape[1:]))
    y[:NLIMBS] = x[:NLIMBS]
    if x.shape[0] > NLIMBS:
        y[:lc] += x[NLIMBS].unsqueeze(0) * c
    _carry_rounds(y, 34)
    y = _resolve_unit_carries(y)[:NLIMBS + 1]
    m17 = int_to_limbs((1 << 256) - limbs_to_int(c_arr), NLIMBS + 1)
    return cond_sub(y, m17)[:NLIMBS]
