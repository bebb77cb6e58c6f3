"""RFC 6979 HMAC-SHA256 DRBG for deterministic ECDSA nonces, in Python.

A copy of `secp256k1_tpu.models.rfc6979`, including the deferred state
update between reads (step h.3 applied at the next read).  The port's
signing entry points derive nonces with the native batch DRBG
(`secp256k1_tpu_torch.native`); this class is its plain reference in the
tests.
"""

from __future__ import annotations

import hashlib
import hmac


class DrbgRFC6979:
    """HMAC_DRBG per RFC 6979 3.2, instantiated with key x and digest
    scalar e (both 32-byte big-endian)."""

    def __init__(self, x_bytes: bytes, e_bytes: bytes):
        assert len(x_bytes) == 32 and len(e_bytes) == 32
        self.v = b"\x01" * 32
        self.k = b"\x00" * 32
        self._init_update(0x00, x_bytes, e_bytes)   # step d
        self._update_v()                             # step e
        self._init_update(0x01, x_bytes, e_bytes)   # step f
        self._update_v()                             # step g
        self.need_update = False

    def _hmac(self, *parts: bytes) -> bytes:
        m = hmac.new(self.k, digestmod=hashlib.sha256)
        for p in parts:
            m.update(p)
        return m.digest()

    def _init_update(self, octet: int, x: bytes, e: bytes):
        self.k = self._hmac(self.v, bytes([octet]), x, e)

    def _update_v(self):
        self.v = self._hmac(self.v)

    def _update_k(self):
        self.k = self._hmac(self.v, b"\x00")

    def read(self, n: int) -> bytes:
        if n != 32:
            raise ValueError("invalid RFC6979 read length")
        if self.need_update:
            self._update_k()
            self._update_v()
        self._update_v()
        self.need_update = True
        return self.v


class RFC6979SHA256:
    """Sentinel requesting deterministic RFC 6979 nonces.  Reading from it
    is a bug."""

    def read(self, n: int) -> bytes:
        raise RuntimeError("RFC6979SHA256 sentinel read() called")
