"""Bitcoin consensus verify of a block's signatures through
`models.bitcoin.verify_asn1_batch_arrays`: SEC1 keys, 32-byte digests,
DER rows with their sighash byte and lengths in, int32 statuses out.

Configuration keys: `distinct_triples` (the seeded pool of distinct
(key, digest, signature) triples), `sig_row_bytes`, `sighash_byte`.
Traffic keys: `lanes` a call (a multiple of the pool), `ring` (distinct
batches cycled through in the window), `corrupt_share` (the share of lanes
corrupted, split evenly over the four kinds of `KINDS`).
"""

from __future__ import annotations

import numpy as np

import seeds
import yardstick
from reference import consensus, curve

# The number the check compares, with the limit 0.
CHECK = "status_mismatches"
CHAINS = 64
# A corrupted lane fails one consensus rule a node must enforce exactly.
KINDS = ("bip66", "high_s", "digest", "off_curve")
# The port's functions the traced run wraps: (module, name, device span).
SPANS = (
    ("secp256k1_tpu_torch.models.ecdsa", "_verify_impl", True),
    ("secp256k1_tpu_torch.models.bitcoin", "bip0066_valid_np", False),
    ("secp256k1_tpu_torch.models.ecdsa", "_e2e_host_parse", False),
    ("secp256k1_tpu_torch.models.ecdsa", "_e2e_dispatch", False),
    ("secp256k1_tpu_torch.ops.s11n", "decompress", False),
)


class Pool:
    """`size` distinct triples of seeded keys, digests and low-s
    signatures.  Keys and nonces come from `CHAINS` progressions (one
    batched point addition a triple each); their discrete logs stay here
    for the reference."""

    def __init__(self, size: int, row_bytes: int, sighash: int, gen,
                 comb: curve.Comb):
        n = curve.N
        ds, keys = curve.progression(
            comb, [seeds.scalar(gen, 1, n) for _ in range(CHAINS)],
            seeds.scalar(gen, 1, n), size)
        ks, nonces = curve.progression(
            comb, [seeds.scalar(gen, 1, n) for _ in range(CHAINS)],
            seeds.scalar(gen, 1, n), size)
        self.digests = gen.integers(0, 256, (size, 32), dtype=np.uint8)
        es = [int.from_bytes(row.tobytes(), "big") % n
              for row in self.digests]
        rs = [q[0] % n for q in nonces]
        k_inv = curve.inv_all(ks, n)
        self.rs, self.ss = rs, []
        self.sigs = np.zeros((size, row_bytes), np.uint8)
        self.lens = np.zeros(size, np.int32)
        for i in range(size):
            s = k_inv[i] * (es[i] + rs[i] * ds[i]) % n
            if not rs[i] or not s:
                raise ArithmeticError("r or s is 0: choose another seed")
            s = min(s, n - s)
            self.ss.append(s)
            row = consensus.der_signature(rs[i], s) + bytes([sighash])
            self.sigs[i, :len(row)] = np.frombuffer(row, np.uint8)
            self.lens[i] = len(row)
        enc = [curve.compressed(q) for q in keys]
        self.pubs = np.frombuffer(b"".join(enc), np.uint8).reshape(size, 33)
        self.key_logs = dict(zip(enc, ds))


class Batch:
    def __init__(self, pubs, digests, sigs, lens, corrupted):
        self.pubs, self.digests, self.sigs, self.lens = (
            pubs, digests, sigs, lens)
        self.corrupted = corrupted        # kind -> lanes
        self.ops = pubs.shape[0]


def _off_curve_x(gen) -> bytes:
    while True:
        x = seeds.scalar(gen, 0, curve.P)
        if curve.lift_x(x, False) is None:
            return x.to_bytes(32, "big")


def _bip66_break(row: bytes, variant: int) -> bytes:
    """The row (DER and sighash byte) made to fail BIP-0066 one way."""
    if variant == 0:                      # not a SEQUENCE
        return b"\x31" + row[1:]
    if variant == 1:                      # the sighash byte missing
        return row[:-1]
    if variant == 2 and len(row) < 73:    # r with a superfluous zero byte
        len_r = row[3]
        return (bytes([0x30, row[1] + 1, 0x02, len_r + 1, 0x00])
                + row[4:])
    return row[:1] + bytes([row[1] + 1]) + row[2:]   # a wrong length


def make_batch(pool: Pool, lanes: int, share: float, gen) -> Batch:
    """The pool tiled over `lanes` in a seeded permutation, then the
    corrupted lanes."""
    size = pool.pubs.shape[0]
    if lanes % size:
        raise ValueError(f"lanes {lanes} is not a multiple of the pool "
                         f"{size}")
    src = gen.permutation(np.tile(np.arange(size), lanes // size))
    pubs, digests = pool.pubs[src], pool.digests[src]
    sigs, lens = pool.sigs[src], pool.lens[src].copy()
    per_kind = max(1, round(lanes * share / len(KINDS)))
    picks = gen.choice(lanes, per_kind * len(KINDS), replace=False)
    corrupted = {k: picks[j * per_kind:(j + 1) * per_kind]
                 for j, k in enumerate(KINDS)}

    def put(i, row):
        sigs[i] = 0
        sigs[i, :len(row)] = np.frombuffer(row, np.uint8)
        lens[i] = len(row)

    for i in corrupted["bip66"]:
        put(i, _bip66_break(sigs[i, :lens[i]].tobytes(),
                            int(gen.integers(4))))
    for i in corrupted["high_s"]:
        j = src[i]
        put(i, consensus.der_signature(pool.rs[j], curve.N - pool.ss[j])
            + sigs[i, lens[i] - 1:lens[i]].tobytes())
    for i in corrupted["digest"]:
        digests[i, gen.integers(32)] ^= np.uint8(1 << int(gen.integers(8)))
    for i in corrupted["off_curve"]:
        pubs[i, 1:] = np.frombuffer(_off_curve_x(gen), np.uint8)
    return Batch(pubs, digests, sigs, lens, corrupted)


class Cell:
    """The configuration's pool and the traffic's ring of batches, made
    from the seed; the timed call, its control and the reference."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.comb = curve.Comb()
        self.pool = Pool(config["distinct_triples"], config["sig_row_bytes"],
                         config["sighash_byte"],
                         seeds.rng(seed, seeds.POOL), self.comb)
        self.ring = [make_batch(self.pool, mix["lanes"], mix["corrupt_share"],
                                seeds.rng(seed, seeds.RING, i))
                     for i in range(mix["ring"])]

    def bind(self, device):
        """Import the program and fix the device (set-up, not timed)."""
        from secp256k1_tpu_torch.models import bitcoin, ecdsa
        self.bitcoin, self.ecdsa, self.device = bitcoin, ecdsa, device

    def call(self, b: Batch) -> np.ndarray:
        return self.bitcoin.verify_asn1_batch_arrays(
            b.pubs, b.digests, b.sigs, b.lens, device=self.device)

    def control(self, b: Batch) -> np.ndarray:
        """The program's own path with low s not enforced: BIP-0066, then
        `ecdsa.verify_batch_arrays(reject_malleable=False)`."""
        enc_ok = self.bitcoin.bip0066_valid_np(b.sigs, b.lens)
        lens = np.where(enc_ok, b.lens - 1, 2).astype(np.int32)
        sigs = b.sigs.copy()
        sigs[~enc_ok, :2] = (0x30, 0x00)
        st = self.ecdsa.verify_batch_arrays(
            b.pubs, b.digests, sigs, lens, reject_malleable=False,
            device=self.device)
        return np.where(enc_ok, st, consensus.ERR_INVALID_ENCODING)

    def expected(self) -> list:
        """Each ring batch's statuses, worked out row by distinct row."""
        cols = [np.concatenate([getattr(b, f) for b in self.ring])
                for f in ("pubs", "digests", "sigs")]
        lens = np.concatenate([b.lens for b in self.ring])
        first, inverse = consensus.distinct_rows(
            *cols, lens.astype("<i4").view(np.uint8).reshape(-1, 4))
        st = consensus.statuses(cols[0][first], cols[1][first],
                                cols[2][first], lens[first],
                                self.pool.key_logs, self.comb)[inverse]
        return np.split(st, len(self.ring))

    @staticmethod
    def mismatches(want: np.ndarray, got) -> int:
        """Lanes whose status differs (every lane when got is no array of
        the batch's shape)."""
        got = np.asarray(got)
        if got.shape != want.shape:
            return int(want.size)
        return int((got != want).sum())

    @staticmethod
    def work(b: Batch) -> dict:
        return {"k_glv_signed": yardstick.glv_signed_work(b.ops)}
