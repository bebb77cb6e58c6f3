"""Host-side python-int secp256k1 affine arithmetic.

Used for parsing and validating single keys, for offline table generation,
and as the slow-but-obviously-correct oracle of the tests and the chip smoke.
The throughput path is always the batched device code in `ops/`.  A copy of
`secp256k1_tpu.utils.hostcurve`, so that the port never imports the JAX
package.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow((x2 - x1) % P, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def mul(k, p1):
    acc = None
    while k:
        if k & 1:
            acc = add(acc, p1)
        p1 = add(p1, p1)
        k >>= 1
    return acc


def neg(p1):
    if p1 is None:
        return None
    return (p1[0], (-p1[1]) % P)


def on_curve(p1) -> bool:
    if p1 is None:
        return True
    x, y = p1
    return (y * y - x * x * x - B) % P == 0


def lift_x(x: int, want_odd: bool):
    """Decompress: y with given parity, or None if x^3+7 is not a QR."""
    if not 0 <= x < P:
        return None
    yy = (x * x * x + B) % P
    y = pow(yy, (P + 1) // 4, P)
    if y * y % P != yy:
        return None
    if (y & 1) != int(want_odd):
        y = P - y
    return (x, y)


def decode_point(data: bytes):
    """Strict SEC1 decode -> (x, y) | None (identity).  Raises ValueError."""
    if len(data) == 1 and data[0] == 0x00:
        return None
    if len(data) == 33 and data[0] in (0x02, 0x03):
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            raise ValueError("invalid x")
        p1 = lift_x(x, data[0] == 0x03)
        if p1 is None:
            raise ValueError("not on curve")
        return p1
    if len(data) == 65 and data[0] == 0x04:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        if x >= P or y >= P:
            raise ValueError("invalid coordinates")
        if not on_curve((x, y)):
            raise ValueError("not on curve")
        return (x, y)
    raise ValueError("invalid point encoding")


def split_uncompressed_point(data: bytes):
    """65-byte uncompressed encoding -> (x_bytes, y_is_odd), the analog of
    the reference's `SplitUncompressedPoint`."""
    if len(data) != 65 or data[0] != 0x04:
        raise ValueError("invalid uncompressed point")
    return data[1:33], bool(data[64] & 1)


def encode_point(p1, compressed: bool = False) -> bytes:
    if p1 is None:
        return b"\x00"
    x, y = p1
    if compressed:
        return bytes([0x02 | (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
