"""SEC 1 public-key decoding on device, batched: the port of the verify
path's part of `secp256k1_tpu.ops.s11n` (compressed decode with a square
root, uncompressed decode with a curve check)."""

from __future__ import annotations

import torch

from . import field as fe
from . import point as pt
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
