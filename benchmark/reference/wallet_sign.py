"""Bitcoin Core's wallet signer in python ints, batched over lanes on the
comb of `curve.py`.

Core's `CKey::Sign` (`src/key.cpp`) over libsecp256k1: the nonce is
`nonce_function_rfc6979`, an RFC 6979 HMAC-SHA256 DRBG seeded with key ||
(digest mod n) || [32 bytes of additional data]; `secp256k1_ecdsa_sign`
draws the DRBG's next output while the nonce is not in [1, n) or r or s is
0, and makes s low; attempt 0 passes no additional data, attempt c >= 1
passes WriteLE32(c) || 0^28, until the compact r's first byte is below
0x80; the output is `secp256k1_ecdsa_signature_serialize_der` with the
sighash byte appended.  The rounds here run every lane still high-R at
once, so that each round's k * G and k^-1 share the comb's batched
inversions; a lane's bytes do not depend on that order.  Nothing here
guards a secret from side channels, and nothing of it does in outputs.

`sign` splits the lanes over worker processes (started by spawn, so that
nothing of the caller's state is shared) where it is given more than one.
"""

from __future__ import annotations

import hashlib
import hmac
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from . import consensus, curve

N = curve.N
_COMB = None


def _hmac(key: bytes, *parts: bytes) -> bytes:
    return hmac.new(key, b"".join(parts), hashlib.sha256).digest()


def nonce(key32: bytes, msg32: bytes, extra32: bytes, counter: int) -> int:
    """The (counter + 1)-th output of the DRBG seeded with key32 || msg32 ||
    extra32 (msg32 the digest mod n, extra32 empty or 32 bytes)."""
    seed = key32 + msg32 + extra32
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
    return int.from_bytes(v, "big")


def grind_extra(attempt: int) -> bytes:
    return b"" if attempt == 0 else attempt.to_bytes(4, "little") + bytes(28)


def _sign_one(d: int, e: int, extra: bytes, comb) -> tuple:
    """One lane's `secp256k1_ecdsa_sign`, the DRBG's counter included."""
    counter = 0
    while True:
        k = nonce(d.to_bytes(32, "big"), e.to_bytes(32, "big"), extra,
                  counter)
        counter += 1
        if not 0 < k < N:
            continue
        r = comb.mul_batch([k])[0][0] % N
        s = pow(k, -1, N) * (e + r * d) % N
        if r and s:
            return r, min(s, N - s)


def sign_lanes(keys: list, digests: list, sighash: int, grind: bool,
               comb=None) -> tuple:
    """(DER || sighash rows, attempts) of each lane; keys python ints in
    [1, n), digests 32-byte strings."""
    comb = comb or _comb()
    es = [int.from_bytes(dg, "big") % N for dg in digests]
    out = [None] * len(keys)
    attempts = [0] * len(keys)
    todo = list(range(len(keys)))
    attempt = 0
    while todo:
        extra = grind_extra(attempt)
        ks = [nonce(keys[i].to_bytes(32, "big"), es[i].to_bytes(32, "big"),
                    extra, 0) for i in todo]
        ok = [0 < k < N for k in ks]
        pts = comb.mul_batch([k if g else 1 for k, g in zip(ks, ok)])
        invs = curve.inv_all([k if g else 1 for k, g in zip(ks, ok)], N)
        high = []
        for j, i in enumerate(todo):
            r = pts[j][0] % N
            s = invs[j] * (es[i] + r * keys[i]) % N
            if ok[j] and r and s:
                r, s = r, min(s, N - s)
            else:
                r, s = _sign_one(keys[i], es[i], extra, comb)
            attempts[i] = attempt + 1
            if grind and r >> 255:
                high.append(i)
            else:
                out[i] = consensus.der_signature(r, s) + bytes([sighash])
        todo = high
        attempt += 1
    return out, attempts


def _comb():
    global _COMB
    if _COMB is None:
        _COMB = curve.Comb()
    return _COMB


def _chunk(args):
    return sign_lanes(*args)


def sign(keys: list, digests: list, sighash: int, grind: bool,
         workers: int = 1, comb=None) -> tuple:
    """`sign_lanes` over `workers` processes, each a contiguous share of
    the lanes."""
    if workers <= 1:
        return sign_lanes(keys, digests, sighash, grind, comb)
    step = -(-len(keys) // workers)
    parts = [(keys[lo:lo + step], digests[lo:lo + step], sighash, grind)
             for lo in range(0, len(keys), step)]
    rows, attempts = [], []
    with ProcessPoolExecutor(len(parts), mp_context=get_context("spawn")) \
            as pool:
        for r, a in pool.map(_chunk, parts):
            rows += r
            attempts += a
    return rows, attempts
