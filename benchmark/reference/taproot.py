"""Bitcoin Core's Taproot signature check in python ints, `hashlib` and
NumPy, batched over rows on the comb of `curve.py`.

Core's `GenericTransactionSignatureChecker::CheckSchnorrSignature`
(`src/script/interpreter.cpp`) under BIP-0341 and BIP-0342, with the
port's status numbers:

    length not 64 or 65                                   1  SIG_SIZE
    65 bytes, last byte 0x00 or not 0x01-0x03, 0x81-0x83  12  SIG_HASHTYPE
    BIP-0340 verify of the first 64 bytes fails           7  SIG
    otherwise                                             0

BIP-0340 verify is written from the BIP: lift_x of the key (x < p, x^3 +
7 a square, even y), r < p, s < n, e = tagged_hash("BIP0340/challenge",
r || P || m) mod n, R = s G - e P, then R finite, y(R) even and x(R) = r.
Where the key is one whose discrete log d the benchmark made (d G with
even y), R = (s - e d) G on the comb, batched; any other key that lifts is
multiplied out.  `statuses` splits the rows over worker processes (started
by spawn, so that nothing of the caller's state is shared) where it is
given more than one.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from . import curve

OK = 0
SIG_SIZE = 1
SIG = 7
SIG_HASHTYPE = 12
HASH_TYPES = (0x01, 0x02, 0x03, 0x81, 0x82, 0x83)

N = curve.N
_TAG = hashlib.sha256(b"BIP0340/challenge").digest()
_CHALLENGE = hashlib.sha256(_TAG + _TAG)
_COMB = None


def challenge(r32: bytes, p32: bytes, m32: bytes) -> int:
    """tagged_hash("BIP0340/challenge", r || P || m) as an integer (not
    yet reduced mod n)."""
    h = _CHALLENGE.copy()
    h.update(r32 + p32 + m32)
    return int.from_bytes(h.digest(), "big")


def rule_status(sig: bytes, length: int):
    """The size and hash-type rules: a status, or None where the row goes
    on to BIP-0340 verify.  `sig` is the zero-padded row; a length past it
    is rejected by the length alone."""
    if length not in (64, 65):
        return SIG_SIZE
    if length == 65 and sig[64] not in HASH_TYPES:
        return SIG_HASHTYPE
    return None


def _final(big_r, r: int) -> int:
    if big_r is None or big_r[1] & 1 or big_r[0] != r:
        return SIG
    return OK


def rows_statuses(pubs: list, digests: list, sigs: list, lens: list,
                  logs: list, comb=None) -> list:
    """Statuses of rows given as byte strings, each row's key log or
    None."""
    comb = comb or _comb()
    out = [SIG] * len(pubs)
    known, ts = [], []
    for i, (pub, dig, sig, ln, d) in enumerate(zip(pubs, digests, sigs,
                                                   lens, logs)):
        st = rule_status(sig, ln)
        if st is not None:
            out[i] = st
            continue
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        key = None
        if d is None:
            key = curve.lift_x(int.from_bytes(pub, "big"), False)
            if key is None:
                continue
        if r >= curve.P or s >= N:
            continue
        e = challenge(sig[:32], pub, dig) % N
        if d is None:
            out[i] = _final(curve.add(curve.mul(s, curve.G),
                                      curve.mul(N - e, key)), r)
        else:
            known.append((i, r))
            ts.append((s - e * d) % N)
    for (i, r), big_r in zip(known, comb.mul_batch(ts)):
        out[i] = _final(big_r, r)
    return out


def _comb():
    global _COMB
    if _COMB is None:
        _COMB = curve.Comb()
    return _COMB


def _chunk(args):
    return rows_statuses(*args)


def statuses(pub_x: np.ndarray, digests: np.ndarray, sigs: np.ndarray,
             lens: np.ndarray, key_logs: dict, comb=None,
             workers: int = 1) -> np.ndarray:
    """[n] int32 statuses of the rows (pub_x [n, 32], digests [n, 32],
    sigs [n, W] zero-padded, lens [n]); key_logs maps a key's 32 bytes to
    its discrete log.  `workers` processes take a contiguous share of the
    rows each."""
    pubs = [r.tobytes() for r in pub_x]
    cols = (pubs, [r.tobytes() for r in digests],
            [r.tobytes() for r in sigs], [int(v) for v in lens],
            [key_logs.get(p) for p in pubs])
    if workers <= 1:
        return np.array(rows_statuses(*cols, comb=comb), np.int32)
    step = -(-len(pubs) // workers)
    parts = [tuple(c[lo:lo + step] for c in cols)
             for lo in range(0, len(pubs), step)]
    out = []
    with ProcessPoolExecutor(len(parts), mp_context=get_context("spawn")) \
            as pool:
        for st in pool.map(_chunk, parts):
            out += st
    return np.array(out, np.int32)
