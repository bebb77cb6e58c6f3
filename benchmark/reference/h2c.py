"""RFC 9380 hash-to-curve, suite `secp256k1_XMD:SHA-256_SSWU_RO_`, in
python ints and `hashlib`, written from the RFC.

- section 5.3.1, `expand_message_xmd` with SHA-256;
- section 5.2, `hash_to_field` with L = 48 and count 2;
- section 6.6.2, the simplified SWU map on the isogenous curve E' (A', B'
  and Z of section 8.7) in its plain form, not the constant-time one of
  appendix F.2: `is_square` and `sqrt` by one `pow` to (p + 1) / 4, the
  inversions of a batch (`inv0`) by one;
- appendix E.1, the 3-isogeny from E' to secp256k1, a zero denominator
  giving the identity;
- the sum of the two points on `curve.py` (the cofactor is 1).

`points` splits the messages over worker processes (started by spawn, so
that nothing of the caller's state is shared) where it is given more than
one.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from . import curve

P = curve.P
L = 48
# Section 8.7: E': y^2 = x^3 + A' x + B', and Z = -11.
A_PRIME = 0x3F8731ABDD661ADCA08A5558F0F5D272E953D363CB6F0E5D405447C01A444533
B_PRIME = 1771
Z = P - 11
# Appendix E.1: k_(i,j), the coefficients of x_num (1), x_den (2), y_num
# (3) and y_den (4), lowest degree first; x_den and y_den are monic.
X_NUM = (0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA8C7,
         0x07D3D4C80BC321D5B9F315CEA7FD44C5D595D2FC0BF63B92DFFF1044F17C6581,
         0x534C328D23F234E6E2A413DECA25CAECE4506144037C40314ECBD0B53D9DD262,
         0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA88C)
X_DEN = (0xD35771193D94918A9CA34CCBB7B640DD86CD409542F8487D9FE6B745781EB49B,
         0xEDADC6F64383DC1DF7C4B2D51B54225406D36B641F5E41BBC52A56612A8C6D14,
         1)
Y_NUM = (0x4BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684B8E38E23C,
         0xC75E0C32D5CB7C0FA9D0A54B12A0A6D5647AB046D686DA6FDFFC90FC201D71A3,
         0x29A6194691F91A73715209EF6512E576722830A201BE2018A765E85A9ECEE931,
         0x2F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F38E38D84)
Y_DEN = (0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFF93B,
         0x7A06534BB8BDB49FD5E9E6632722C2989467C1BFC8E8D978DFB425D2685C2573,
         0x6484AA716545CA2CF3A70C3FA8FE337E0A3D21162F0D6299A7BF8192BFD2A76F,
         1)


def expand_message_xmd(msg: bytes, dst: bytes, n_out: int) -> bytes:
    """Section 5.3.1 with SHA-256 (b_in_bytes 32, s_in_bytes 64), a DST
    longer than 255 bytes first reduced as section 5.3.3 says."""
    ell = -(-n_out // 32)
    if ell > 255 or n_out > 65535 or not dst:
        raise ValueError("expand_message_xmd: bad length or DST")
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + n_out.to_bytes(2, "big")
                        + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        b.append(hashlib.sha256(bytes(x ^ y for x, y in zip(b0, b[-1]))
                                + bytes([i]) + dst_prime).digest())
    return b"".join(b)[:n_out]


def hash_to_field(msg: bytes, dst: bytes, count: int = 2) -> list:
    """Section 5.2 with m = 1: count elements of F_p, L bytes each."""
    uniform = expand_message_xmd(msg, dst, count * L)
    return [int.from_bytes(uniform[i * L:(i + 1) * L], "big") % P
            for i in range(count)]


def _inv0_all(vals: list) -> list:
    """inv0 of section 4 over a list (1 / x, and 0 for 0), with one
    inversion (Montgomery's trick)."""
    vals = [v % P for v in vals]
    invs = curve.inv_all([v or 1 for v in vals], P)
    return [i if v else 0 for v, i in zip(vals, invs)]


def _root(x: int) -> int:
    """x^((p + 1) / 4): a square root of x where x is a square, else one
    of -x (p = 3 mod 4, so -1 is no square)."""
    return pow(x, (P + 1) // 4, P)


_MINUS_B_OVER_A, _B_OVER_ZA = _inv0_all([A_PRIME, Z * A_PRIME])
_MINUS_B_OVER_A = (P - B_PRIME) * _MINUS_B_OVER_A % P
_B_OVER_ZA = B_PRIME * _B_OVER_ZA % P
# sqrt(-Z^3) = sqrt(1331): -Z = 11 is a square, as Z is none.
_ROOT_MINUS_Z3 = _root(11 ** 3)
assert _ROOT_MINUS_Z3 ** 2 % P == 11 ** 3


def map_to_curve_sswu(us: list) -> list:
    """Section 6.6.2 over a list of u: [(x', y')] on E'.  Where gx1 is no
    square, r = gx1^((p + 1) / 4) is a root of -gx1, and gx2 = Z^3 u^6 gx1
    = (-Z^3) u^6 (-gx1) has the root sqrt(-Z^3) u^3 r: one `pow` a map,
    each root checked by squaring it."""
    out = []
    for u, tv1 in zip(us, _inv0_all([Z * Z * pow(u, 4, P) + Z * u * u
                                     for u in us])):
        x1 = _MINUS_B_OVER_A * (1 + tv1) % P
        if tv1 == 0:
            x1 = _B_OVER_ZA
        gx1 = (x1 ** 3 + A_PRIME * x1 + B_PRIME) % P
        x, y = x1, _root(gx1)
        if y * y % P != gx1:              # is_square(gx1) is false
            x = Z * u * u * x1 % P
            y = _ROOT_MINUS_Z3 * pow(u, 3, P) * y % P
            if y * y % P != (x ** 3 + A_PRIME * x + B_PRIME) % P:
                raise ArithmeticError("gx2 is no square")
        if u % 2 != y % 2:                # sgn0 with m = 1
            y = (P - y) % P
        out.append((x, y))
    return out


def _poly(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def iso_map(points: list) -> list:
    """Appendix E.1 over a list of (x', y'): the 3-isogeny of each, None
    (the identity) where a denominator is 0."""
    dens = [(_poly(X_DEN, x), _poly(Y_DEN, x)) for x, _ in points]
    invs = _inv0_all([d for pair in dens for d in pair])
    out = []
    for (x, y), (xd, yd), xi, yi in zip(points, dens, invs[0::2],
                                        invs[1::2]):
        if xd == 0 or yd == 0:
            out.append(None)
        else:
            out.append((_poly(X_NUM, x) * xi % P,
                        y * _poly(Y_NUM, x) * yi % P))
    return out


def hash_to_curve(msgs: list, dst: bytes) -> list:
    """The RO suite over a list of messages: affine (x, y) on secp256k1,
    None for the identity."""
    us = [u for m in msgs for u in hash_to_field(m, dst)]
    qs = iso_map(map_to_curve_sswu(us))
    return curve.add_batch(qs[0::2], qs[1::2])


def _chunk(args):
    return hash_to_curve(*args)


def points(rows: np.ndarray, lens: np.ndarray, dst: bytes,
           workers: int = 1):
    """The suite over zero-padded rows [n, W] u8, row i the message of its
    first lens[i] bytes: (points [n, 64] u8 affine x || y big-endian,
    zeros for the identity; is_identity [n] bool).  `workers` processes
    take a contiguous share of the rows each."""
    msgs = [r[:n].tobytes() for r, n in zip(rows, lens)]
    if workers <= 1:
        pts = hash_to_curve(msgs, dst)
    else:
        step = -(-len(msgs) // workers)
        parts = [(msgs[lo:lo + step], dst)
                 for lo in range(0, len(msgs), step)]
        pts = []
        with ProcessPoolExecutor(len(parts),
                                 mp_context=get_context("spawn")) as pool:
            for chunk in pool.map(_chunk, parts):
                pts += chunk
    ident = np.array([q is None for q in pts], bool)
    out = np.zeros((len(pts), 64), np.uint8)
    if len(pts):
        out[~ident] = np.frombuffer(b"".join(
            q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
            for q in pts if q is not None), np.uint8).reshape(-1, 64)
    return out, ident
