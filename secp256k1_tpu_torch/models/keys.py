"""ECDSA key types with the reference's invariants.

A copy of `secp256k1_tpu.models.keys` on the port's python-int curve
(`utils/hostcurve.py`): a private scalar always lies in [1, n), a public key
is never the identity and always on the curve, and keys are sampled by
rejection.  Key checks and encodings run on the host; `sign`, `verify` and
`ecdh` go through the device pipelines of `models/ecdsa.py` and
`models/ecdh.py`.
"""

from __future__ import annotations

import hmac as _hmac
import os

from ..utils import hostcurve as hc
from . import codecs

N = hc.N
MAX_SCALAR_RESAMPLES = 8


class KeyError_(ValueError):
    pass


class PublicKey:
    """secp256k1 public key (never the identity)."""

    __slots__ = ("point", "point_bytes")

    def __init__(self, point):
        if point is None:
            raise KeyError_("public key is the point at infinity")
        if not hc.on_curve(point):
            raise KeyError_("point not on curve")
        self.point = point
        self.point_bytes = hc.encode_point(point, compressed=False)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        """SEC1 encoded point (compressed or uncompressed; the identity is
        rejected)."""
        try:
            point = hc.decode_point(data)
        except ValueError as e:
            raise KeyError_(str(e)) from e
        return cls(point)

    @classmethod
    def from_asn1(cls, data: bytes) -> "PublicKey":
        return cls.from_bytes(codecs.parse_asn1_public_key_bytes(data))

    def bytes(self) -> bytes:
        return self.point_bytes

    def compressed_bytes(self) -> bytes:
        return hc.encode_point(self.point, compressed=True)

    def asn1_bytes(self) -> bytes:
        return codecs.build_asn1_public_key(self.point_bytes)

    def x_bytes(self) -> bytes:
        return self.point[0].to_bytes(32, "big")

    def __eq__(self, other):
        if not isinstance(other, PublicKey):
            return NotImplemented
        return _hmac.compare_digest(self.point_bytes, other.point_bytes)

    def __hash__(self):
        return hash(self.point_bytes)

    def verify(self, digest: bytes, sig: bytes, opts=None,
               device=None) -> bool:
        from . import ecdsa as _ecdsa
        return _ecdsa.verify(self, digest, sig, opts=opts, device=device)


class PrivateKey:
    """secp256k1 private key; scalar invariant [1, n)."""

    __slots__ = ("scalar", "public_key")

    def __init__(self, scalar: int):
        if not 1 <= scalar < N:
            raise KeyError_("private key scalar out of range")
        self.scalar = scalar
        self.public_key = PublicKey(hc.mul(scalar, hc.G))

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivateKey":
        if len(data) != 32:
            raise KeyError_("invalid private key size")
        v = int.from_bytes(data, "big")
        if v == 0 or v >= N:
            raise KeyError_("invalid private key scalar")
        return cls(v)

    def bytes(self) -> bytes:
        return self.scalar.to_bytes(32, "big")

    def __eq__(self, other):
        if not isinstance(other, PrivateKey):
            return NotImplemented
        return _hmac.compare_digest(self.bytes(), other.bytes())

    def __hash__(self):
        return hash(self.bytes())

    def ecdh(self, remote: PublicKey, device=None) -> bytes:
        """SEC1 §3.3.1 shared secret, x-coordinate bytes: a one-pair batch
        of `ecdh.ecdh_batch` on the device (the GPU unless "cpu")."""
        from . import ecdh as _ecdh
        return _ecdh.ecdh_batch([self], [remote], device=device)[0]

    def sign(self, digest: bytes, rand=None, opts=None,
             device=None) -> bytes:
        from . import ecdsa as _ecdsa
        return _ecdsa.sign(self, digest, rand=rand, opts=opts, device=device)


def sample_random_scalar(read_fn) -> int:
    """Rejection sampling in [1, n) with bounded retries."""
    for _ in range(MAX_SCALAR_RESAMPLES):
        v = int.from_bytes(read_fn(32), "big")
        if 1 <= v < N:
            return v
    raise KeyError_("failed rejection sampling")


def generate_key(read_fn=None) -> PrivateKey:
    if read_fn is None:
        read_fn = os.urandom
    return PrivateKey(sample_random_scalar(read_fn))
