"""Bitcoin consensus ECDSA verify of one row, in python ints.

The status codes and their precedence are the program's public contract
(`utils/errors.py` of the port, the same numbers as the JAX package's):

    BIP-0066 encoding            1  invalid encoding
    strict DER parse             1  malformed, 4 r or s zero or >= n
    key prefix not 02 / 03       3  invalid public key
    s > n / 2 (low s)            9  malleable
    x >= p or x^3 + 7 no square  3  invalid public key
    u1 G + u2 Q at infinity     10  R is infinity
    x(R) mod n != r             11  v != r
    otherwise                    0

`statuses` recomputes them for every distinct row of a batch.  Where the
key is one whose discrete log d the benchmark made, u1 G + u2 Q is computed
as (u1 + u2 d) G on the comb; any other key that decodes is multiplied out.
"""

from __future__ import annotations

import numpy as np

from . import curve

OK = 0
ERR_INVALID_ENCODING = 1
ERR_INVALID_PUBLIC_KEY = 3
ERR_INVALID_SCALAR = 4
ERR_MALLEABLE = 9
ERR_R_IS_INFINITY = 10
ERR_V_NEQ_R = 11

N = curve.N


def bip66_valid(sig: bytes) -> bool:
    """Bitcoin Core's IsValidSignatureEncoding (BIP-0066), the trailing
    sighash byte included."""
    n = len(sig)
    if n < 9 or n > 73 or sig[0] != 0x30 or sig[1] != n - 3:
        return False
    len_r = sig[3]
    if 5 + len_r >= n:
        return False
    len_s = sig[5 + len_r]
    if len_r + len_s + 7 != n or sig[2] != 0x02 or len_r == 0:
        return False
    if sig[4] & 0x80 or (len_r > 1 and sig[4] == 0 and not sig[5] & 0x80):
        return False
    if sig[len_r + 4] != 0x02 or len_s == 0 or sig[len_r + 6] & 0x80:
        return False
    if len_s > 1 and sig[len_r + 6] == 0 and not sig[len_r + 7] & 0x80:
        return False
    return True


def der_int(v: int) -> bytes:
    body = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    if body[0] & 0x80:
        body = b"\x00" + body
    return b"\x02" + bytes([len(body)]) + body


def der_signature(r: int, s: int) -> bytes:
    body = der_int(r) + der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _tlv(data: bytes, off: int):
    """(tag, content, next offset) of a strict-DER TLV, or None."""
    if off + 2 > len(data):
        return None
    tag, lb = data[off], data[off + 1]
    off += 2
    if lb == 0x80:
        return None
    if lb > 0x80:
        k = lb & 0x7F
        if k > 4 or off + k > len(data) or data[off] == 0:
            return None
        length = int.from_bytes(data[off:off + k], "big")
        if length < 0x80:
            return None
        off += k
    else:
        length = lb
    if off + length > len(data):
        return None
    return tag, data[off:off + length], off + length


def _der_scalar(c: bytes):
    """(status, value) of a DER INTEGER that must lie in [1, n)."""
    if not c or c[0] & 0x80 or (len(c) > 1 and c[0] == 0
                                and not c[1] & 0x80):
        return ERR_INVALID_ENCODING, 0
    v = int.from_bytes(c, "big")
    if len(c.lstrip(b"\x00")) > 32 or not 0 < v < N:
        return ERR_INVALID_SCALAR, 0
    return OK, v


def parse_der(sig: bytes):
    """(status, r, s) of SEQUENCE { r INTEGER, s INTEGER }, strict DER:
    the structure first, then the ranges, r before s."""
    seq = _tlv(sig, 0)
    if seq is None or seq[0] != 0x30 or seq[2] != len(sig):
        return ERR_INVALID_ENCODING, 0, 0
    body = seq[1]
    r_tlv = _tlv(body, 0)
    if r_tlv is None or r_tlv[0] != 0x02:
        return ERR_INVALID_ENCODING, 0, 0
    s_tlv = _tlv(body, r_tlv[2])
    if s_tlv is None or s_tlv[0] != 0x02 or s_tlv[2] != len(body):
        return ERR_INVALID_ENCODING, 0, 0
    st, r = _der_scalar(r_tlv[1])
    if st:
        return st, 0, 0
    st, s = _der_scalar(s_tlv[1])
    return st, r, s


def _early_status(pub: bytes, sig: bytes):
    """(status, r, s, key point) up to the curve arithmetic; status None
    where the row goes on to u1 G + u2 Q."""
    if not bip66_valid(sig):
        return ERR_INVALID_ENCODING, 0, 0, None
    st, r, s = parse_der(sig[:-1])
    if st:
        return st, 0, 0, None
    if pub[0] not in (2, 3):
        return ERR_INVALID_PUBLIC_KEY, 0, 0, None
    if s > N // 2:
        return ERR_MALLEABLE, 0, 0, None
    return None, r, s, pub


def statuses(pubs: np.ndarray, digests: np.ndarray, sigs: np.ndarray,
             lens: np.ndarray, key_logs: dict, comb: curve.Comb) -> np.ndarray:
    """[n] int32 consensus statuses of the rows (pubs [n, 33], digests
    [n, 32], sigs [n, W] zero-padded, lens [n]).  key_logs maps a
    compressed key's 33 bytes to its discrete log."""
    n = pubs.shape[0]
    out = np.zeros(n, np.int32)
    pending = []                     # (row, r, e, s, log or point)
    for i in range(n):
        sig = sigs[i, :lens[i]].tobytes()
        pub = pubs[i].tobytes()
        st, r, s, _ = _early_status(pub, sig)
        if st is not None:
            out[i] = st
            continue
        log = key_logs.get(pub)
        if log is None:
            q = curve.lift_x(int.from_bytes(pub[1:], "big"), pub[0] == 3)
            if q is None:
                out[i] = ERR_INVALID_PUBLIC_KEY
                continue
            log = q
        e = int.from_bytes(digests[i].tobytes(), "big") % N
        pending.append((i, r, e, s, log))
    w = curve.inv_all([s for _, _, _, s, _ in pending], N)
    logs, others = [], []
    for (i, r, e, s, log), s_inv in zip(pending, w):
        u1, u2 = e * s_inv % N, r * s_inv % N
        if isinstance(log, int):
            logs.append((i, r, (u1 + u2 * log) % N))
        else:
            others.append((i, r, curve.add(curve.mul(u1, curve.G),
                                           curve.mul(u2, log))))
    points = comb.mul_batch([t for _, _, t in logs])
    for (i, r, _), big_r in zip(logs, points):
        out[i] = _final(big_r, r)
    for i, r, big_r in others:
        out[i] = _final(big_r, r)
    return out


def _final(big_r, r: int) -> int:
    if big_r is None:
        return ERR_R_IS_INFINITY
    return OK if big_r[0] % N == r else ERR_V_NEQ_R


def distinct_rows(*cols: np.ndarray):
    """(index of each distinct row, inverse) over side-by-side uint8
    columns [n, w_k], so a batch tiled from a pool is checked row by
    distinct row."""
    rows = np.ascontiguousarray(np.concatenate(cols, axis=1))
    view = rows.view(np.dtype((np.void, rows.shape[1]))).ravel()
    _, first, inverse = np.unique(view, return_index=True,
                                  return_inverse=True)
    return first, inverse.ravel()
