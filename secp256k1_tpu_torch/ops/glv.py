"""GLV endomorphism scalar multiplication, batched (PyTorch).

The port of `secp256k1_tpu.ops.glv`: the balanced length-two split
(libsecp256k1's g1/g2 precomputed division), the signed and the nibble
window digits, and the three engines the JAX package takes on its TPU,
chosen by its own switches (`kernels.set_mega`, `set_mega_signed`) on both
devices here:

- mega, signed (default): the whole loop in one launch of
  `glv_windowed_mult_signed_from_points` (8-entry tables per lane);
- mega, unsigned: one launch of `glv_windowed_mult_from_points` (15-entry
  tables);
- not mega: two lane tables (`table.build_lane_table`), then from the
  identity 32 windows of `point.double_n(acc, 4)` (one `point_double4`)
  and two `point_lookup_add` launches.

The three give the same affine point; the projective X, Y, Z of each equal
the JAX package's for the same engine.
"""

from __future__ import annotations

from . import field as fe
from . import limbs as lb
from . import point as pt
from . import scalar as sc
from . import table as tbl
from .cuda import kernels as K

NEG_LAMBDA = 0xAC9C52B33FA3CF1F5AD9E3FD77ED9BA4A880B9FC8EC739C2E0CFC810B51283CF
LAMBDA = sc.N - NEG_LAMBDA
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
NEG_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
NEG_B2 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFE8A280AC50774346DD765CDA83DB1562C
G1 = 0x3086D221A7D46BCDE86C90E49284EB153DAA8A1471E8CA7FE893209A45DBB031
G2 = 0xE4437ED6010E88286F547FA90ABFE4C4221208AC9DF506C61571B4AE8AC47F71

_G1_LIMBS = lb.int_to_limbs(G1)
_G2_LIMBS = lb.int_to_limbs(G2)
_NEG_B1_LIMBS = lb.int_to_limbs(NEG_B1)
_NEG_B2_LIMBS = lb.int_to_limbs(NEG_B2)
_NEG_LAMBDA_LIMBS = lb.int_to_limbs(NEG_LAMBDA)

def _mul_g_floored_div(k, g_limbs):
    """floor(k * g / 2^384) + rounding bit (bit 383), as a scalar plane."""
    wide = lb.mul_wide(k, lb.const_plane(g_limbs, k))
    hi = wide[24:32]                         # value < 2^128
    round_bit = (wide[23] >> 15) & 1
    c = lb.carry_prop(lb.add_raw(hi, round_bit.unsqueeze(0)), 9, bits=17)
    return lb.pad_limbs(c, 0, lb.NLIMBS - 9)


def _mul_const_mod_n(a, c_limbs):
    """a * constant mod n."""
    return lb.mod_fold(lb.mul_const(a, c_limbs), sc.S.c_limbs)


def split(k):
    """Balanced GLV split: k = k1 + k2*lambda (mod n), |k1|, |k2| ~ 2^128.
    Returns canonical int32 mod-n planes (k1, k2)."""
    c1 = _mul_g_floored_div(k, _G1_LIMBS)
    c2 = _mul_g_floored_div(k, _G2_LIMBS)
    k2 = sc.add(_mul_const_mod_n(c1, _NEG_B1_LIMBS),
                _mul_const_mod_n(c2, _NEG_B2_LIMBS))
    k1 = sc.add(k, _mul_const_mod_n(k2, _NEG_LAMBDA_LIMBS))
    return k1, k2


def mul_beta(p: pt.Point) -> pt.Point:
    """The curve endomorphism phi(x, y) = (beta*x, y)."""
    beta = fe.const(BETA, p.x.shape[1:], p.x.device).contiguous()
    return pt.Point(fe.mul(p.x, beta), p.y, p.z)


def _signed_digits_128(k):
    """Low 128 bits -> [33, *B] signed 4-bit window digits, most
    significant first; magnitude (bits 0-3, in [0, 8]) | sign << 4."""
    d = tbl._raw_digits(k[:8], 4, 32)        # least significant first
    return tbl.signed_recode(d, 4, 4).flip(0)


def _nibble_digits_128(k):
    """Low 128 bits of a scalar plane -> [32, *B] nibble digits in
    [0, 15], most significant first."""
    return tbl._raw_digits(k[:8], 4, 32).flip(0).to(lb.DTYPE)


def _short_scalars(k, p: pt.Point):
    """(k1, k2, P1, P2) with k*P = k1*P1 + k2*P2, k1 and k2 below 2^128:
    the split, each short scalar made non-negative by negating its
    point."""
    k1, k2 = split(k)
    neg1 = sc.is_greater_than_half_n(k1)
    neg2 = sc.is_greater_than_half_n(k2)
    k1 = sc.cneg(neg1, k1)
    k2 = sc.cneg(neg2, k2)
    return k1, k2, pt.cneg(neg1, p), pt.cneg(neg2, mul_beta(p))


def glv_kernel_operands(k, p: pt.Point):
    """The signed GLV kernel's operands for k*P: (d1, d2, p1, p2) with
    k*P = k1*P1 + k2*P2, as contiguous int32 digit planes and (x, y, z)
    tuples."""
    k1, k2, p1, p2 = _short_scalars(k, p)
    return (_signed_digits_128(k1).contiguous(),
            _signed_digits_128(k2).contiguous(), pt._planes(p1),
            pt._planes(p2))


def scalar_mult(k, p: pt.Point) -> pt.Point:
    """k*P via GLV: split, negation to short scalars, then the engine the
    switches name (module docstring)."""
    if K.mega_enabled() and K.mega_signed_enabled():
        return pt.Point(*K.glv_windowed_mult_signed_from_points(
            *glv_kernel_operands(k, p)))
    k1, k2, p1, p2 = _short_scalars(k, p)
    d1 = _nibble_digits_128(k1).contiguous()
    d2 = _nibble_digits_128(k2).contiguous()
    if K.mega_enabled():
        return pt.Point(*K.glv_windowed_mult_from_points(
            d1, d2, pt._planes(p1), pt._planes(p2)))
    return lane_table_mult(d1, d2, tbl.build_lane_table(p1),
                           tbl.build_lane_table(p2))


def lane_table_mult(d1, d2, t1, t2) -> pt.Point:
    """The engine without the mega kernels: k1*P1 + k2*P2 from nibble
    digits [W, B] and lane tables [15, 3, 16, B], from the identity, per
    window `double_n(acc, 4)` then two `point_lookup_add` launches: the
    schedule of `glv_windowed_mult` (#9)."""
    acc = pt.identity(tuple(d1.shape[1:]), d1.device)
    for w in range(d1.shape[0]):
        acc = pt.double_n(acc, 4)            # identity doubles to identity
        acc = pt.Point(*K.point_lookup_add(*pt._planes(acc), t1, d1[w]))
        acc = pt.Point(*K.point_lookup_add(*pt._planes(acc), t2, d2[w]))
    return acc


def double_scalar_mult_basepoint(u1, u2, p: pt.Point,
                                 base_window_bits: int = 8) -> pt.Point:
    """u1*G + u2*P, the ECDSA-verify core: GLV for the P term, then the
    fixed-base tables for the G term (`table.scalar_base_mult_add`: on the
    default switches one kernel launch with the final complete add)."""
    return tbl.scalar_base_mult_add(u1, scalar_mult(u2, p), base_window_bits)
