"""Bitcoin Core's Taproot signature check in plain python ints, `hashlib`
and NumPy: the reference the port's `bitcoin.verify_taproot_batch_arrays`
is held to.

It follows `GenericTransactionSignatureChecker::CheckSchnorrSignature`
(`src/script/interpreter.cpp`) under BIP-0341 and BIP-0342:

- a signature of other than 64 or 65 bytes is SCHNORR_SIG_SIZE;
- a 65-byte signature's last byte is its hash type: 0x00
  (SIGHASH_DEFAULT, which may not be explicit) and every byte outside
  0x01-0x03 and 0x81-0x83 (which `SignatureHashSchnorr` refuses) are
  SCHNORR_SIG_HASHTYPE;
- otherwise BIP-0340 `Verify` of the first 64 bytes under the 32-byte
  x-only key over the 32-byte TapSighash, written from the BIP; a failure
  is SCHNORR_SIG.

The statuses are the port's numbers: OK 0, SIG_SIZE 1, SIG_HASHTYPE 12,
SIG 7.  One departure, which shows in no output: where the caller knows a
key's discrete log d (d G with even y), R = (s - e d) G is one
multiplication, the same point as s G - e P.

Nothing here imports JAX, the JAX package or the port.
"""

from __future__ import annotations

import hashlib

import numpy as np

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

OK = 0
SIG_SIZE = 1
SIG = 7
SIG_HASHTYPE = 12
HASH_TYPES = (0x01, 0x02, 0x03, 0x81, 0x82, 0x83)


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


def lift_x(x: int):
    """BIP-0340 `lift_x`: the point with this x and an even y, or None."""
    if x >= P:
        return None
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    return x, y if y & 1 == 0 else P - y


def tagged_hash(tag: str, msg: bytes) -> bytes:
    t = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(t + t + msg).digest()


def schnorr_verify(msg: bytes, pubkey: bytes, sig: bytes,
                   d: int | None = None) -> bool:
    """BIP-0340 `Verify` of a 64-byte signature; d, where given, is the
    key's discrete log."""
    pt = lift_x(int.from_bytes(pubkey, "big"))
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    if pt is None or r >= P or s >= N:
        return False
    e = int.from_bytes(tagged_hash("BIP0340/challenge",
                                   sig[:32] + pubkey + msg), "big") % N
    if d is None:
        big_r = point_add(point_mul(s), point_mul(N - e, pt))
    else:
        big_r = point_mul((s - e * d) % N)
    return big_r is not None and big_r[1] & 1 == 0 and big_r[0] == r


def check(pubkey: bytes, digest: bytes, sig: bytes, length: int,
          d: int | None = None) -> int:
    """`CheckSchnorrSignature`'s status of a signature of `length` bytes
    whose first bytes are `sig` (a length past the row is rejected by the
    length alone)."""
    if length not in (64, 65):
        return SIG_SIZE
    if length == 65 and sig[64] not in HASH_TYPES:
        return SIG_HASHTYPE
    return OK if schnorr_verify(digest, pubkey, sig[:64], d) else SIG


def statuses(pub_x: np.ndarray, digests: np.ndarray, sigs: np.ndarray,
             lens: np.ndarray, key_logs: dict | None = None) -> np.ndarray:
    """[n] int32 statuses of the rows (pub_x [n, 32], digests [n, 32],
    sigs [n, W] zero-padded, lens [n]); key_logs maps a key's 32 bytes to
    its discrete log."""
    logs = key_logs or {}
    return np.array([check(pub_x[i].tobytes(), digests[i].tobytes(),
                           sigs[i].tobytes(), int(lens[i]),
                           logs.get(pub_x[i].tobytes()))
                     for i in range(pub_x.shape[0])], np.int32)
