"""SEC 1 point coding on device, batched: the port of
`secp256k1_tpu.ops.s11n` (compressed decode with a square root,
uncompressed decode with a curve check, the affine, compressed,
uncompressed and x-only encodings, and `recover_point` with the
recovery-id contract: bit 0 the y parity, bit 1 "x >= n")."""

from __future__ import annotations

import torch

from . import field as fe
from . import limbs as lb
from . import point as pt
from . import scalar as sc
from ..utils import errors as ec


def decompress(want_odd, xbytes):
    """Batched SEC1 compressed decode (prefix stripped by the host).

    want_odd: [B] bool (prefix == 0x03); xbytes: [32, B] big-endian.
    Returns (Point, status): status != OK where x is non-canonical or
    x^3 + 7 is not a square."""
    x, did_reduce = fe.from_bytes_any(xbytes)
    yy = fe.add(fe.mul(fe.square(x), x), fe.const(7, x.shape[1:], x.device))
    y, ok = fe.sqrt(yy)
    y = fe.cneg(fe.is_odd(y) != want_odd, y)
    status = torch.where(
        did_reduce, ec.ERR_INVALID_ENCODING,
        torch.where(~ok, ec.ERR_NOT_ON_CURVE, ec.OK)).to(torch.int32)
    return pt.Point(x, y, fe.one(x.shape[1:], x.device)), status


def decode_uncompressed(xbytes, ybytes):
    """Batched SEC1 uncompressed decode: canonical x, y + curve membership."""
    x, xred = fe.from_bytes_any(xbytes)
    y, yred = fe.from_bytes_any(ybytes)
    on = _xy_on_curve(x, y)
    status = torch.where(
        xred | yred, ec.ERR_INVALID_ENCODING,
        torch.where(~on, ec.ERR_NOT_ON_CURVE, ec.OK)).to(torch.int32)
    return pt.Point(x, y, fe.one(x.shape[1:], x.device)), status


def _xy_on_curve(x, y):
    """y^2 == x^3 + 7."""
    lhs = fe.square(y)
    rhs = fe.add(fe.mul(fe.square(x), x), fe.const(7, x.shape[1:], x.device))
    return fe.eq(lhs, rhs)


def _x_cubed_plus_7(x):
    return fe.add(fe.mul(fe.square(x), x), fe.const(7, x.shape[1:], x.device))


def affine_bytes(p: pt.Point):
    """Rescale and serialize: (x bytes [32, B], y bytes [32, B], y odd,
    is identity), with one batched inversion for the batch."""
    aff = pt.to_affine(p)
    return (fe.to_bytes(aff.x), fe.to_bytes(aff.y), fe.is_odd(aff.y),
            pt.is_identity(p))


def compressed_bytes(p: pt.Point):
    """SEC1 compressed encoding: ([33, B] byte plane, identity mask); an
    identity lane encodes as the single byte 0x00 at the host boundary."""
    xb, _, y_odd, is_ident = affine_bytes(p)
    prefix = torch.where(y_odd, 0x03, 0x02).to(xb.dtype)
    return torch.cat([prefix.unsqueeze(0), xb], 0), is_ident


def uncompressed_bytes(p: pt.Point):
    """SEC1 uncompressed encoding: ([65, B] byte plane, identity mask)."""
    xb, yb, _, is_ident = affine_bytes(p)
    four = torch.full((1,) + tuple(xb.shape[1:]), 0x04, dtype=xb.dtype,
                      device=xb.device)
    return torch.cat([four, xb, yb], 0), is_ident


def x_bytes(p: pt.Point):
    """x-only encoding: ([32, B] byte plane, identity mask); x of the
    identity is undefined."""
    xb, _, _, is_ident = affine_bytes(p)
    return xb, is_ident


def recover_point(r_bytes, recovery_id):
    """Batched SEC1 `RecoverPoint`: R from the ECDSA r and its recovery id.

    r_bytes: [32, B] big-endian r (canonical mod n); recovery_id: [B] int32
    in [0, 3], bit 0 the y parity, bit 1 "x = r + n".  The status flags a
    bad id, r not in [1, n), x >= p after adding n, or x^3 + 7 not a
    square."""
    r_limbs = sc.S._bytes_to_limbs(r_bytes)
    r_ok = ~lb.geq_const(r_limbs, sc.S.m_limbs)
    nonzero = ~lb.is_zero(r_limbs)
    overflow = (recovery_id & 2) != 0
    n17 = lb.add(r_limbs, lb.const_plane(sc.S.m_limbs, r_limbs), 17)
    fits = ~lb.geq_const(n17, fe.F.m17_limbs)
    x = lb.select(overflow, n17[:16], r_limbs).to(lb.DTYPE)
    y, is_qr = fe.sqrt(_x_cubed_plus_7(x))
    want_odd = (recovery_id & 1) != 0
    y = fe.cneg(fe.is_odd(y) != want_odd, y)
    bad_id = (recovery_id < 0) | (recovery_id > 3)
    ok = r_ok & nonzero & is_qr & (fits | ~overflow)
    status = torch.where(
        bad_id, ec.ERR_INVALID_RECOVERY_ID,
        torch.where(~ok, ec.ERR_INVALID_ENCODING, ec.OK)).to(torch.int32)
    return pt.Point(x, y, fe.one(x.shape[1:], x.device)), status
