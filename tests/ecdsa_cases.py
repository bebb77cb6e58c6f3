"""ECDSA verify cases shared by the port's CPU tests and its card tests
(python ints only; no JAX, so the card's machine can import it)."""

import hashlib

from secp256k1_tpu_torch.utils import hostcurve as hc


def big_r_triple():
    """(Q, digest, r, s) whose R = u1*G + u2*Q has x_R in [n, p): only the
    r + n < p comparison accepts it (r = x_R - n)."""
    n = hc.N
    x = n
    while True:
        x += 1
        big_r = hc.lift_x(x, False)
        if big_r is not None:
            break
    r = x - n
    digest = hashlib.sha256(b"x_R >= n").digest()
    e = int.from_bytes(digest, "big") % n
    s = 0x1234567890ABCDEF
    r_inv = pow(r, n - 2, n)
    q = hc.add(hc.mul(s * r_inv % n, big_r), hc.neg(hc.mul(e * r_inv % n,
                                                           hc.G)))
    return q, digest, r, s
