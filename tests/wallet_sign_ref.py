"""Bitcoin Core's wallet signer in plain python ints, `hashlib` and `hmac`:
the reference the port's `bitcoin.sign_der_batch_arrays` is held to.

It follows Bitcoin Core's `CKey::Sign` (`src/key.cpp`) over libsecp256k1:

- `nonce_rfc6979` is `nonce_function_rfc6979`: an RFC 6979 HMAC-SHA256
  DRBG seeded with key || (digest mod n) || [32 bytes of additional data],
  which yields its (counter + 1)-th output;
- `ecdsa_sign` is `secp256k1_ecdsa_sign`: the counter goes up while the
  nonce is not in [1, n) or r or s is 0; s is made low (BIP-0146);
- `core_sign` is `CKey::Sign` with grinding: attempt 0 passes no
  additional data, attempt c >= 1 passes WriteLE32(c) || 0^28, until the
  first byte of the compact r is below 0x80;
- `der` is `secp256k1_ecdsa_signature_serialize_der` (strict DER, BIP-0066),
  and the caller appends the sighash byte as Core's signature creator does.

Departures from Core's code, none of which shows in an output: k * G is a
plain double-and-add in affine coordinates, not libsecp256k1's constant-time
comb, and nothing here guards a secret from side channels; keys are python
ints, not 32-byte buffers checked by `secp256k1_ec_seckey_verify` (a key
not in [1, n) is refused by `core_sign` as Core's `CKey` refuses to hold
it).

Nothing here imports JAX, the JAX package or the port.
"""

from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
SIGHASH_ALL = 1


def point_add(p, q):
    """Affine sum; None is the point at infinity."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % P == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return x, (lam * (p[0] - x) - p[1]) % P


def point_mul(k: int, p=G):
    acc = None
    k %= N
    while k:
        if k & 1:
            acc = point_add(acc, p)
        p = point_add(p, p)
        k >>= 1
    return acc


def _hmac(key: bytes, *parts: bytes) -> bytes:
    return hmac.new(key, b"".join(parts), hashlib.sha256).digest()


def nonce_rfc6979(key32: bytes, digest32: bytes, extra32: bytes | None = None,
                  counter: int = 0) -> bytes:
    """libsecp256k1's `nonce_function_rfc6979` (no algorithm tag): the
    (counter + 1)-th 32-byte output of the DRBG seeded with key ||
    (digest mod n) || extra."""
    msg = (int.from_bytes(digest32, "big") % N).to_bytes(32, "big")
    seed = key32 + msg + (extra32 or b"")
    v, k = b"\x01" * 32, b"\x00" * 32
    k = _hmac(k, v, b"\x00", seed)
    v = _hmac(k, v)
    k = _hmac(k, v, b"\x01", seed)
    v = _hmac(k, v)
    for i in range(counter + 1):
        if i:
            k = _hmac(k, v, b"\x00")
            v = _hmac(k, v)
        v = _hmac(k, v)
    return v


def ecdsa_sign(d: int, digest32: bytes, extra32: bytes | None = None):
    """`secp256k1_ecdsa_sign` with that nonce function: (r, s), s low."""
    e = int.from_bytes(digest32, "big") % N
    counter = 0
    while True:
        k = int.from_bytes(nonce_rfc6979(d.to_bytes(32, "big"), digest32,
                                         extra32, counter), "big")
        counter += 1
        if not 0 < k < N:
            continue
        r = point_mul(k)[0] % N
        s = pow(k, -1, N) * (e + r * d) % N
        if r and s:
            return r, min(s, N - s)


def der_int(v: int) -> bytes:
    body = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    if body[0] & 0x80:
        body = b"\x00" + body
    return b"\x02" + bytes([len(body)]) + body


def der(r: int, s: int) -> bytes:
    body = der_int(r) + der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def grind_extra(counter: int) -> bytes:
    """Core's extra entropy for attempt `counter`: WriteLE32 then zeros."""
    return counter.to_bytes(4, "little") + bytes(28)


def core_sign(d: int, digest32: bytes, sighash: int = SIGHASH_ALL,
              grind: bool = True):
    """`CKey::Sign` and the sighash byte: (DER || sighash, attempts, r, s).
    Raises ValueError for a key not in [1, n)."""
    if not 0 < d < N:
        raise ValueError("the key is not in [1, n)")
    r, s = ecdsa_sign(d, digest32)
    attempts = 1
    while grind and r >> 255:
        r, s = ecdsa_sign(d, digest32, grind_extra(attempts))
        attempts += 1
    return der(r, s) + bytes([sighash]), attempts, r, s


def verify(q, digest32: bytes, r: int, s: int) -> bool:
    """Plain ECDSA verify of (r, s) under the affine key q."""
    if not (0 < r < N and 0 < s < N):
        return False
    e = int.from_bytes(digest32, "big") % N
    w = pow(s, -1, N)
    big_r = point_add(point_mul(e * w % N), point_mul(r * w % N, q))
    return big_r is not None and big_r[0] % N == r
