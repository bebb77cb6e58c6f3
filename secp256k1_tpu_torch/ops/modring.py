"""Batched modular arithmetic ring over limb planes (PyTorch).

The port of `secp256k1_tpu.ops.modring`: one `ModRing` each for the base
field (p = 2^256 - 2^32 - 977) and the scalar ring (mod n); both moduli are
2^256 - c with small c, so reduction is Solinas folding.

Elements are canonical everywhere: int32 [16, B] planes, limbs < 2^16,
value < modulus.  `mul`, `square`, `pow2k` and `pow_const_chain` go
through the kernel wrappers of `ops/cuda/kernels.py`, which launch the CUDA
kernels for CUDA tensors and run the plain versions for CPU tensors; the
rest is limb algebra on tensors.  A ring built with `plain=True` never goes
through the wrappers: the plain versions of the point kernels compute with
it.
"""

from __future__ import annotations

import torch

from . import limbs as lb
from .cuda import kernels as K

NLIMBS = lb.NLIMBS
DTYPE = lb.DTYPE
_CONSTS: dict = {}                 # (value, device) -> its [16] limbs


class ModRing:
    """Arithmetic mod m = 2^256 - c for small c, on [16, B] limb planes."""

    def __init__(self, modulus: int, name: str, plain: bool = False):
        assert modulus < (1 << 256)
        self.modulus = modulus
        self.name = name
        self.plain = plain
        c = (1 << 256) - modulus
        n_c_limbs = (c.bit_length() + lb.LIMB_BITS - 1) // lb.LIMB_BITS
        self.c_limbs = lb.int_to_limbs(c, n_c_limbs)
        self.m_limbs = lb.int_to_limbs(modulus, NLIMBS)
        self.m17_limbs = lb.int_to_limbs(modulus, NLIMBS + 1)

    # -- constructors -------------------------------------------------------

    def const(self, v: int, batch_shape, device) -> torch.Tensor:
        """A python-int constant broadcast to a [16, *batch] plane: a view
        of its limbs, uploaded once a device (no copy from the host inside
        a CUDA graph's capture)."""
        key = (v % self.modulus, str(torch.device(device)))
        x = _CONSTS.get(key)
        if x is None:
            x = torch.as_tensor(lb.int_to_limbs(key[0]), dtype=DTYPE,
                                device=device)
            _CONSTS[key] = x
        shape = (NLIMBS,) + tuple(batch_shape)
        return x.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(shape)

    def zero(self, batch_shape, device) -> torch.Tensor:
        return torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=DTYPE,
                           device=device)

    def one(self, batch_shape, device) -> torch.Tensor:
        x = self.zero(batch_shape, device)
        x[0] = 1
        return x

    # -- ring ops -----------------------------------------------------------

    def add(self, a, b):
        s = lb.add(a, b, NLIMBS + 1)          # < 2m
        return lb.cond_sub(s, self.m17_limbs)[:NLIMBS].to(DTYPE)

    def sub(self, a, b):
        # a - b = a + (m - b); b canonical => m - b in [1, m], no borrow.
        d, _ = lb.sub_borrow(lb.const_plane(self.m_limbs, b), b)
        s = lb.add(a, d, NLIMBS + 1)          # < 2m
        return lb.cond_sub(s, self.m17_limbs)[:NLIMBS].to(DTYPE)

    def neg(self, b):
        d, _ = lb.sub_borrow(lb.const_plane(self.m_limbs, b), b)
        return lb.cond_sub(d, self.m_limbs).to(DTYPE)   # m (b = 0) -> 0

    def mul(self, a, b):
        if self.plain:
            return K.mod_mul_plain(a, b, self.modulus)
        return K.mod_mul(_flat(a), _flat(b), self.modulus)

    def square(self, a):
        if self.plain:
            return K.mod_square_plain(a, self.modulus)
        return K.mod_square(_flat(a), self.modulus)

    def many(self, op: str, *args):
        """Apply a binary ring op ("add", "sub" or "mul") to several operand
        pairs in one call: the pairs are stacked along the lanes, so each
        tensor op (and, on CUDA, each `mod_mul` launch) covers all of
        them."""
        n = args[0][0].shape[1]
        out = getattr(self, op)(torch.cat([x for x, _ in args], 1),
                                torch.cat([y for _, y in args], 1))
        return list(out.split(n, 1))

    def mul_word(self, a, w: int):
        """Multiply by a small constant word (e.g. b3 = 21)."""
        return lb.mod_fold(lb.mul_word(a, w), self.c_limbs).to(DTYPE)

    def pow2k(self, x, k: int):
        """x^(2^k): one `mod_pow2k` launch for k >= 2, `square` for k = 1,
        as the JAX ring routes them."""
        assert k >= 1
        if k == 1:
            return self.square(x)
        if self.plain:
            return K.mod_pow2k_plain(x, k, self.modulus)
        return K.mod_pow2k(_flat(x), k, self.modulus)

    def pow_const_chain(self, x, e: int):
        """x^e for a constant e >= 1 (the value of the JAX
        `ModRing.pow_const_chain`) by the addition chain of
        `kernels.pow_chain_steps`: ~bitlen squarings and 15-46 multiplies
        for the exponents here, one `mod_pow_chain` launch on CUDA.

        The modulus is prime, so x^e = x^e' for every canonical x (0
        included) with e' = ((e - 1) mod (m - 1)) + 1, in [1, m - 1]: e is
        reduced first, which leaves the exponents in [1, m - 1] (those of
        `invert` and `field.sqrt`) as they are.  An e' whose chain exceeds
        the kernel's step list (most random 256-bit exponents) is split
        into parts e' = e_1 + ... + e_k of its bits, each part's chain one
        launch, and x^e' = x^e_1 ... x^e_k by `mul`.  The chain's steps
        depend on e alone, so the time does not depend on x."""
        parts = self._exponent_parts(e)
        out = self._chain(x, parts[0])
        for part in parts[1:]:
            out = self.mul(out, self._chain(x, part))
        return out

    def pow_const(self, x, e: int):
        """x^e for a public constant e >= 1: the canonical value that the
        JAX `ModRing.pow_const` computes by 4-bit fixed windows, here by
        the chains of `pow_const_chain`."""
        return self.pow_const_chain(x, e)

    def _exponent_parts(self, e: int) -> list:
        """The exponents of the chains that compute x^e: e' =
        ((e - 1) mod (m - 1)) + 1, split by `_chain_parts`."""
        if e < 1:
            raise ValueError(f"pow_const: e must be >= 1, got {e}")
        return _chain_parts((e - 1) % (self.modulus - 1) + 1)

    def _chain(self, x, e: int):
        """x^e by one chain: one `mod_pow_chain` launch on CUDA."""
        if self.plain:
            return K.mod_pow_chain_plain(x, e, self.modulus)
        return K.mod_pow_chain(_flat(x), e, self.modulus)

    def invert(self, x):
        """Fermat inverse x^(m-2); maps 0 -> 0."""
        return self.pow_const_chain(x, self.modulus - 2)

    def invert_auto(self, x, min_batch: int = 2048):
        """`invert_batch` from `min_batch` lanes up, per-lane Fermat below."""
        if x.shape[1] >= min_batch:
            return self.invert_batch(x)
        return self.invert(x)

    def invert_batch(self, x):
        """Montgomery batch inversion: a product tree, ONE Fermat chain at
        its root (width 1), and a down-sweep; zero lanes map to 0.  Any
        width B >= 1; the tree pads with ones to a power of two."""
        b = x.shape[1]
        if b == 1:
            return self.invert(x)
        zero_lane = lb.is_zero(x)
        vals = lb.select(~zero_lane, x, self.one((b,), x.device))
        b_pad = 1 << (b - 1).bit_length()
        if b_pad != b:
            vals = torch.cat([vals, self.one((b_pad - b,), x.device)], 1)
        levels = [vals]
        while levels[-1].shape[1] > 1:
            cur = levels[-1]
            levels.append(self.mul(cur[:, 0::2], cur[:, 1::2]))
        inv = self.invert(levels[-1])
        for cur in levels[-2::-1]:
            even, odd = cur[:, 0::2], cur[:, 1::2]
            inv_even = self.mul(inv, odd)
            inv_odd = self.mul(inv, even)
            inv = torch.stack([inv_even, inv_odd], dim=2).reshape(
                NLIMBS, cur.shape[1])
        inv = inv[:, :b]
        return lb.select(~zero_lane, inv, self.zero((b,), x.device))

    def sum_lanes(self, x):
        """The modular sum of all lanes of a [16, B] plane, the batched
        `Scalar.Sum` of the reference.  Returns [16, 1]."""
        return self._lane_tree(x, self.add)

    def product_lanes(self, x):
        """The modular product of all lanes, the batched `Scalar.Product`:
        one `mul` (a `mod_mul` launch on CUDA) a level of the tree, 16 at
        65,536 lanes.  Returns [16, 1]."""
        return self._lane_tree(x, self.mul)

    @staticmethod
    def _lane_tree(x, op):
        """The JAX pairwise tree over the lanes: the first half op the
        second half, level by level, an odd last lane carried to the next
        level."""
        flat = x.reshape(NLIMBS, -1)
        k = flat.shape[1]
        while k > 1:
            half = k // 2
            pair = op(flat[:, :half], flat[:, half:2 * half])
            if k % 2:
                pair = torch.cat([pair, flat[:, 2 * half:]], 1)
            flat = pair
            k = flat.shape[1]
        return flat

    # -- predicates / selects ----------------------------------------------

    def is_zero(self, x):
        return lb.is_zero(x)

    def eq(self, a, b):
        return lb.eq(a, b)

    def is_odd(self, x):
        return (x[0] & 1) == 1

    def gt_half(self, x):
        """x > floor(m/2)."""
        h1 = lb.int_to_limbs((self.modulus >> 1) + 1, NLIMBS)
        return lb.geq_const(x, h1)

    def select(self, mask, a, b):
        """mask ? a : b, per lane."""
        return lb.select(mask, a, b)

    def cneg(self, mask, x):
        """Negate where mask (branchless)."""
        return lb.select(mask, self.neg(x), x)

    # -- byte boundary ------------------------------------------------------

    def from_bytes_any(self, byts):
        """[32, B] big-endian bytes -> (reduced element, did_reduce mask of
        lanes whose input was >= m)."""
        x = self._bytes_to_limbs(byts)
        did_reduce = lb.geq_const(x, self.m_limbs)
        return lb.mod_fold(x, self.c_limbs).to(DTYPE), did_reduce

    def from_wide_bytes(self, byts):
        """[W <= 64, B] big-endian bytes -> the fully reduced element (the
        48-byte strings of hash-to-curve: 24 limbs into `lb.mod_fold`)."""
        if byts.shape[0] > 64:
            raise ValueError(f"at most 64 bytes a lane, got {byts.shape[0]}")
        return lb.mod_fold(self._bytes_to_limbs(byts), self.c_limbs).to(DTYPE)

    def to_bytes(self, x):
        """[16, B] canonical element -> [32, B] big-endian bytes (0..255)."""
        x = x.flip(0)
        return torch.stack([x >> 8, x & 0xFF], dim=1).reshape(
            (2 * NLIMBS,) + tuple(x.shape[1:]))

    def bytes_are_canonical(self, byts):
        """[32, B] big-endian bytes -> bool [B]: the value is below m."""
        return ~lb.geq_const(self._bytes_to_limbs(byts), self.m_limbs)

    def _bytes_to_limbs(self, byts):
        """[NB, B] big-endian bytes -> [ceil(NB/2), B] int64 LE limbs."""
        b = byts.to(lb.WIDE)
        nb = b.shape[0]
        if nb % 2:
            b = lb.pad_limbs(b, 1, 0)
        pairs = b.flip(0).reshape((b.shape[0] // 2, 2) + tuple(b.shape[1:]))
        return pairs[:, 0] | (pairs[:, 1] << 8)


def _chain_parts(e: int) -> list:
    """e as a sum of parts whose chains fit the chain kernel: e itself, else
    its set bits split at the middle of their span, each half split again
    as it needs.  Any e below 2^4096 splits; `ModRing` passes e < 2^256."""
    try:
        K.pow_chain_steps(e)
        return [e]
    except ValueError:
        low = (e & -e).bit_length() - 1
        if e.bit_length() - low < 2:         # one set bit: no shorter chain
            raise
    mid = (low + e.bit_length()) // 2
    hi = e >> mid << mid
    return _chain_parts(hi) + _chain_parts(e - hi)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """An int32 [16, B] contiguous plane, as the kernel wrappers take."""
    return x.to(DTYPE).contiguous()
