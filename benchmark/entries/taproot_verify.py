"""Taproot block verification through
`models.bitcoin.verify_taproot_batch_arrays`: x-only output keys,
TapSighash digests, 64- or 65-byte BIP-0340 signatures (zero-padded rows)
and their lengths in, int32 statuses in Bitcoin Core's precedence out.

Configuration keys: `sig_row_bytes`.  Traffic keys: `lanes` a call, `ring`
(batches cycled through in the window; every lane of every batch is a
distinct (key, digest, signature) triple, as on the chain),
`corrupt_share` (the share of lanes corrupted, split evenly over the five
kinds of `KINDS`) and `explicit_hashtype_share` (the share of lanes whose
valid signature carries an explicit hash type, drawn evenly from the six
valid ones).
"""

from __future__ import annotations

import os

import numpy as np

import seeds
import yardstick
from reference import curve, taproot

# The number the check compares, with the limit 0.
CHECK = "status_mismatches"
CHAINS = 64
# A corrupted lane fails one of Core's Schnorr rules: its size, its hash
# type, a key off the curve, a digest that is not the one signed, s >= n.
KINDS = ("size", "hashtype", "key", "digest", "s")
BAD_HASH_TYPES = (0x00, 0x04, 0x80, 0x84)
# The reference splits the ring over this many processes at most, one a
# 4,096 rows.
REFERENCE_WORKERS = 8
# The port's functions the traced run wraps: (module, name, device span).
SPANS = (
    ("secp256k1_tpu_torch.models.bitcoin", "_taproot_host_parse", False),
    ("secp256k1_tpu_torch.native", "tagged_hash_batch", False),
    ("secp256k1_tpu_torch.models.schnorr", "_schnorr_verify_e2e_core",
     True),
)


def _rows32(vals) -> np.ndarray:
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(-1, 32)


class Pool:
    """`size` distinct triples of x-only keys, digests and BIP-0340
    signatures.  Keys and nonces come from `CHAINS` progressions (one
    batched point addition a triple each), made even-y as BIP-0340 makes
    them; the keys' discrete logs stay here for the reference."""

    def __init__(self, size: int, gen, comb: curve.Comb):
        n = curve.N
        ds, keys = curve.progression(
            comb, [seeds.scalar(gen, 1, n) for _ in range(CHAINS)],
            seeds.scalar(gen, 1, n), size)
        ks, nonces = curve.progression(
            comb, [seeds.scalar(gen, 1, n) for _ in range(CHAINS)],
            seeds.scalar(gen, 1, n), size)
        self.digests = gen.integers(0, 256, (size, 32), dtype=np.uint8)
        self.pub_x = _rows32(q[0] for q in keys)
        rx = _rows32(q[0] for q in nonces)
        if np.unique(self.pub_x, axis=0).shape[0] != size:
            raise ArithmeticError("a key repeats: choose another seed")
        logs = [d if q[1] % 2 == 0 else n - d for d, q in zip(ds, keys)]
        ss = []
        for i in range(size):
            k = ks[i] if nonces[i][1] % 2 == 0 else n - ks[i]
            e = taproot.challenge(rx[i].tobytes(), self.pub_x[i].tobytes(),
                                  self.digests[i].tobytes()) % n
            ss.append((k + e * logs[i]) % n)
        self.sigs = np.concatenate([rx, _rows32(ss)], axis=1)
        self.key_logs = dict(zip((r.tobytes() for r in self.pub_x), logs))


class Batch:
    def __init__(self, pubs, digests, sigs, lens, corrupted, explicit):
        self.pubs, self.digests, self.sigs, self.lens = (
            pubs, digests, sigs, lens)
        self.corrupted = corrupted        # kind -> lanes
        self.explicit = explicit          # valid lanes of 65 bytes
        self.ops = pubs.shape[0]


def _off_curve_x(gen) -> bytes:
    while True:
        x = seeds.scalar(gen, 0, curve.P)
        if curve.lift_x(x, False) is None:
            return x.to_bytes(32, "big")


def make_batch(pool: Pool, lo: int, lanes: int, mix: dict, row_bytes: int,
               gen) -> Batch:
    """The pool's rows lo .. lo + lanes, then the corrupted lanes and the
    lanes with an explicit valid hash type, on distinct lanes."""
    pubs = pool.pub_x[lo:lo + lanes].copy()
    digests = pool.digests[lo:lo + lanes].copy()
    sigs = np.zeros((lanes, row_bytes), np.uint8)
    sigs[:, :64] = pool.sigs[lo:lo + lanes]
    lens = np.full(lanes, 64, np.int32)
    per_kind = max(1, round(lanes * mix["corrupt_share"] / len(KINDS)))
    n_explicit = max(1, round(lanes * mix["explicit_hashtype_share"]))
    picks = gen.choice(lanes, per_kind * len(KINDS) + n_explicit,
                       replace=False)
    corrupted = {k: picks[j * per_kind:(j + 1) * per_kind]
                 for j, k in enumerate(KINDS)}
    explicit = picks[per_kind * len(KINDS):]
    valid = np.array(taproot.HASH_TYPES, np.uint8)
    sigs[explicit, 64] = valid[gen.integers(len(valid), size=n_explicit)]
    lens[explicit] = 65
    for i in corrupted["size"]:
        if gen.integers(2):               # 66 bytes: its first 65 in the row
            sigs[i, 64] = valid[gen.integers(len(valid))]
            lens[i] = 66
        else:                             # 63 bytes
            sigs[i, 63] = 0
            lens[i] = 63
    for i in corrupted["hashtype"]:
        sigs[i, 64] = BAD_HASH_TYPES[gen.integers(len(BAD_HASH_TYPES))]
        lens[i] = 65
    for i in corrupted["key"]:
        pubs[i] = np.frombuffer(_off_curve_x(gen), np.uint8)
    for i in corrupted["digest"]:
        digests[i, gen.integers(32)] ^= np.uint8(1 << int(gen.integers(8)))
    for i in corrupted["s"]:
        sigs[i, 32:64] = _rows32([seeds.scalar(gen, curve.N, 2**256)])[0]
    return Batch(pubs, digests, sigs, lens, corrupted, explicit)


class Cell:
    """The pool, one distinct share of it a ring batch, made from the
    seed; the timed call, its control and the reference."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.comb = curve.Comb()
        lanes, ring = mix["lanes"], mix["ring"]
        self.pool = Pool(lanes * ring, seeds.rng(seed, seeds.POOL),
                         self.comb)
        self.ring = [make_batch(self.pool, i * lanes, lanes, mix,
                                config["sig_row_bytes"],
                                seeds.rng(seed, seeds.RING, i))
                     for i in range(ring)]

    def bind(self, device):
        """Import the program and fix the device (set-up, not timed); a
        program without the Taproot check fails here."""
        from secp256k1_tpu_torch.models import bitcoin
        if not hasattr(bitcoin, "verify_taproot_batch_arrays"):
            raise AttributeError("the program has no "
                                 "bitcoin.verify_taproot_batch_arrays")
        self.bitcoin, self.device = bitcoin, device

    def call(self, b: Batch) -> np.ndarray:
        return self.bitcoin.verify_taproot_batch_arrays(
            b.pubs, b.digests, b.sigs, b.lens, device=self.device)

    def control(self, b: Batch) -> np.ndarray:
        """The program's own path with the hash-type rule not enforced:
        every 65-byte lane's hash type made 0x01, so a lane whose hash
        type is invalid verifies its 64 bytes and differs."""
        sigs = b.sigs.copy()
        sigs[b.lens == 65, 64] = 0x01
        return self.bitcoin.verify_taproot_batch_arrays(
            b.pubs, b.digests, sigs, b.lens, device=self.device)

    def expected(self) -> list:
        """Each ring batch's statuses, by the reference."""
        cols = [np.concatenate([getattr(b, f) for b in self.ring])
                for f in ("pubs", "digests", "sigs", "lens")]
        workers = max(1, min(REFERENCE_WORKERS, os.cpu_count() or 1,
                             cols[0].shape[0] // 4096))
        st = taproot.statuses(*cols, self.pool.key_logs, self.comb,
                              workers)
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
