"""secp256k1 in plain python ints.

Affine points are (x, y) tuples and the point at infinity is None.  Every
batch of affine additions shares one field inversion (Montgomery's trick):
in CPython a lone inversion costs as much as some forty products, so the
pools and the reference add lane by lane in batches.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

COMB_BITS = 8
COMB_WINDOWS = 256 // COMB_BITS


def inv_all(vals: list, m: int) -> list:
    """Inverses mod m of nonzero vals, with one modular inversion."""
    prefix = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        acc = acc * v % m
    inv = pow(acc, -1, m)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % m
        inv = inv * vals[i] % m
    return out


def add_batch(ps: list, qs: list) -> list:
    """Lane-wise affine sums ps[i] + qs[i] (doubling and infinity included)."""
    dens = []
    for p, q in zip(ps, qs):
        if p is None or q is None:
            dens.append(1)
        elif p[0] != q[0]:
            dens.append((q[0] - p[0]) % P)
        elif p[1] == q[1] and p[1]:
            dens.append(2 * p[1] % P)
        else:
            dens.append(1)
    invs = inv_all(dens, P)
    out = []
    for p, q, iv in zip(ps, qs, invs):
        if p is None or q is None:
            out.append(q if p is None else p)
            continue
        if p[0] != q[0]:
            lam = (q[1] - p[1]) * iv % P
        elif p[1] == q[1] and p[1]:
            lam = 3 * p[0] * p[0] * iv % P
        else:
            out.append(None)
            continue
        x = (lam * lam - p[0] - q[0]) % P
        out.append((x, (lam * (p[0] - x) - p[1]) % P))
    return out


def add(p, q):
    return add_batch([p], [q])[0]


def neg(p):
    return None if p is None else (p[0], (-p[1]) % P)


def mul(k: int, p):
    """k * p by double-and-add (for the rare lane that has no known log)."""
    acc = None
    k %= N
    while k:
        if k & 1:
            acc = add(acc, p)
        p = add(p, p)
        k >>= 1
    return acc


def lift_x(x: int, odd: bool):
    """The point with this x and y parity, or None when x >= p or x^3 + 7
    is not a square."""
    if x >= P:
        return None
    v = (x ** 3 + 7) % P
    y = pow(v, (P + 1) // 4, P)
    if y * y % P != v:
        return None
    return (x, y if (y & 1) == odd else P - y)


def compressed(p) -> bytes:
    return bytes([2 | (p[1] & 1)]) + p[0].to_bytes(32, "big")


def uncompressed(p) -> bytes:
    return b"\x04" + p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


class Comb:
    """k * G over a table of d * 2^(8w) * G, d in 1..255, w in 0..31: one
    affine addition a nonzero byte of k, batched over lanes."""

    def __init__(self):
        bases = [G]
        for _ in range(COMB_WINDOWS - 1):
            b = bases[-1]
            for _ in range(COMB_BITS):
                b = add(b, b)
            bases.append(b)
        self.rows = [[b] for b in bases]
        for _ in range(2, 1 << COMB_BITS):
            nxt = add_batch([r[-1] for r in self.rows], bases)
            for r, q in zip(self.rows, nxt):
                r.append(q)

    def mul_batch(self, ks: list) -> list:
        ks = [k % N for k in ks]
        acc = [None] * len(ks)
        for w, row in enumerate(self.rows):
            lanes = [i for i, k in enumerate(ks)
                     if (k >> (COMB_BITS * w)) & 0xFF]
            sums = add_batch(
                [acc[i] for i in lanes],
                [row[((ks[i] >> (COMB_BITS * w)) & 0xFF) - 1] for i in lanes])
            for i, s in zip(lanes, sums):
                acc[i] = s
        return acc


def progression(comb: Comb, starts: list, step: int, count: int):
    """count scalars and their points: len(starts) chains, chain c holding
    starts[c] + t * step for t = 0, 1, ..., one batched addition of
    step * G a link.  Returns (scalars, points), chain after chain."""
    n_chains = len(starts)
    links = -(-count // n_chains)
    heads = comb.mul_batch(starts)
    stride = comb.mul_batch([step])[0]
    cols = [heads]
    for _ in range(links - 1):
        cols.append(add_batch(cols[-1], [stride] * n_chains))
    scalars, points = [], []
    for c in range(n_chains):
        for t in range(links):
            scalars.append((starts[c] + t * step) % N)
            points.append(cols[t][c])
    if any(q is None for q in points[:count]):
        raise ArithmeticError("a pool scalar is 0 mod n: choose another seed")
    return scalars[:count], points[:count]
