"""Simplified SWU map and 3-isogeny for RFC 9380 hash-to-curve, batched.

The port of `secp256k1_tpu.ops.swu`: the straight-line RFC 9380 F.2
simplified SWU method on the isogenous curve E' (A', B' != 0), the
3-isogeny back to secp256k1 with the RFC's k_(i,j) constants, and the
exceptional lanes (a zero denominator) mapped to the identity.  Every step
is the JAX module's, so every intermediate value is the same; the
constants are the public RFC 9380 suite parameters (section 8.7, appendix
E.1).

The products run through `field.mul` and `field.square` (`mod_mul`,
`mod_square` on CUDA), the square root ratio and the inversions through one
`mod_pow_chain` launch each (invert(0) = 0).  `iso_map` stacks its
independent products into one `mod_mul` call (`ModRing.many`), which
leaves every lane's value as it is.
"""

from __future__ import annotations

from . import field as fe
from . import point as pt

# RFC 9380 secp256k1 suite constants (section 8.7).
Z = fe.Z_SSWU
A_PRIME = 0x3F8731ABDD661ADCA08A5558F0F5D272E953D363CB6F0E5D405447C01A444533
B_PRIME = 1771

K10 = 0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA8C7
K11 = 0x07D3D4C80BC321D5B9F315CEA7FD44C5D595D2FC0BF63B92DFFF1044F17C6581
K12 = 0x534C328D23F234E6E2A413DECA25CAECE4506144037C40314ECBD0B53D9DD262
K13 = 0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA88C
K20 = 0xD35771193D94918A9CA34CCBB7B640DD86CD409542F8487D9FE6B745781EB49B
K21 = 0xEDADC6F64383DC1DF7C4B2D51B54225406D36B641F5E41BBC52A56612A8C6D14
K30 = 0x4BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684B8E38E23C
K31 = 0xC75E0C32D5CB7C0FA9D0A54B12A0A6D5647AB046D686DA6FDFFC90FC201D71A3
K32 = 0x29A6194691F91A73715209EF6512E576722830A201BE2018A765E85A9ECEE931
K33 = 0x2F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F38E38D84
K40 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFF93B
K41 = 0x7A06534BB8BDB49FD5E9E6632722C2989467C1BFC8E8D978DFB425D2685C2573
K42 = 0x6484AA716545CA2CF3A70C3FA8FE337E0A3D21162F0D6299A7BF8192BFD2A76F


def _c(v, like):
    return fe.const(v, like.shape[1:], like.device)


def map_to_curve_simple_swu(u):
    """RFC 9380 F.2 simplified SWU on E' for [16, B] field elements u.
    Returns (x', y') on E'."""
    one = fe.one(u.shape[1:], u.device)
    tv1 = fe.square(u)
    tv1 = fe.mul(_c(Z, u), tv1)
    tv2 = fe.square(tv1)
    tv2 = fe.add(tv2, tv1)
    tv3 = fe.add(tv2, one)
    tv3 = fe.mul(_c(B_PRIME, u), tv3)
    tv2_zero = fe.is_zero(tv2)
    tv4 = fe.select(tv2_zero, _c(Z, u), fe.neg(tv2))
    tv4 = fe.mul(_c(A_PRIME, u), tv4)
    tv2 = fe.square(tv3)
    tv6 = fe.square(tv4)
    tv5 = fe.mul(_c(A_PRIME, u), tv6)
    tv2 = fe.add(tv2, tv5)
    tv2 = fe.mul(tv2, tv3)
    tv6 = fe.mul(tv6, tv4)
    tv5 = fe.mul(_c(B_PRIME, u), tv6)
    tv2 = fe.add(tv2, tv5)
    x = fe.mul(tv1, tv3)
    y1, is_gx1_square = fe.sqrt_ratio(tv2, tv6)
    y = fe.mul(tv1, u)
    y = fe.mul(y, y1)
    x = fe.select(is_gx1_square, tv3, x)
    y = fe.select(is_gx1_square, y1, y)
    e1 = fe.is_odd(u) == fe.is_odd(y)
    y = fe.cneg(~e1, y)
    x = fe.mul(x, fe.invert(tv4))
    return x, y


def iso_map(x, y):
    """The 3-isogeny E' -> secp256k1.  Returns (x, y, on_curve_mask): the
    mask is False where a denominator was zero (callers map those lanes to
    the identity)."""
    xx = fe.square(x)
    xxx = fe.mul(xx, x)
    (k13_xxx, k12_xx, k11_x, k21_x, k33_xxx, k32_xx, k31_x, k42_xx,
     k41_x) = fe.F.many(
        "mul", (_c(K13, x), xxx), (_c(K12, x), xx), (_c(K11, x), x),
        (_c(K21, x), x), (_c(K33, x), xxx), (_c(K32, x), xx),
        (_c(K31, x), x), (_c(K42, x), xx), (_c(K41, x), x))

    x_num = fe.add(k13_xxx, k12_xx)
    x_num = fe.add(x_num, k11_x)
    x_num = fe.add(x_num, _c(K10, x))

    x_den = fe.add(k21_x, xx)
    x_den = fe.add(x_den, _c(K20, x))
    x_den_zero = fe.is_zero(x_den)
    x_den_inv = fe.invert(x_den)

    y_num = fe.add(k33_xxx, k32_xx)
    y_num = fe.add(y_num, k31_x)
    y_num = fe.add(y_num, _c(K30, x))

    y_den = fe.add(k42_xx, k41_x)
    y_den = fe.add(y_den, xxx)
    y_den = fe.add(y_den, _c(K40, x))
    y_den_zero = fe.is_zero(y_den)

    x_out, y_ratio = fe.F.many("mul", (x_num, x_den_inv),
                               (y_num, fe.invert(y_den)))
    y_out = fe.mul(y, y_ratio)
    return x_out, y_out, ~(x_den_zero | y_den_zero)


def set_uniform_bytes(byts):
    """48-byte uniform strings -> curve points: wide reduction, SWU,
    isogeny, the identity on exceptional lanes.  byts: [48, B] uint8."""
    u = fe.from_wide_bytes(byts)
    xp, yp = map_to_curve_simple_swu(u)
    x, y, ok = iso_map(xp, yp)
    p = pt.Point(x, y, fe.one(x.shape[1:], x.device))
    return pt.select(ok, p, pt.identity(x.shape[1:], x.device))
