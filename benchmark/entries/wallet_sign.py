"""Bitcoin Core's wallet signer through `models.bitcoin.sign_der_batch_arrays`:
[n, 32] private keys and sighash digests in; DER signatures with the
sighash byte, their lengths and int32 statuses out, ground to low R as
Core grinds them.

Configuration keys: `sighash_byte`, `low_r_grind`.  Traffic keys: `lanes`
a call (distinct keys in every lane of every batch), `ring` (distinct
batches cycled through in the window), `sighash` (the byte appended).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

import seeds
import yardstick_sign
from reference import curve, wallet_sign

# The number the check compares, with the limit 0.
CHECK = "sig_mismatches"
DER_ROW_BYTES = 72
# The reference splits a batch over this many processes at most, one a
# 4,096 lanes.
REFERENCE_WORKERS = 8
# The port's functions the traced run wraps: (module, name, device span).
SPANS = (
    ("secp256k1_tpu_torch.native", "rfc6979_nonce_batch", False),
    ("secp256k1_tpu_torch.models.ecdsa", "_sign_e2e_core", True),
    ("secp256k1_tpu_torch.native", "der_sig_encode_batch", False),
)

_N_ROW = np.frombuffer(curve.N.to_bytes(32, "big"), np.uint8)


class Batch:
    def __init__(self, priv, digests):
        self.priv, self.digests = priv, digests
        self.ops = priv.shape[0]
        self.attempted = None          # lanes signed over every round


class Signed(NamedTuple):
    """A call's answer and the program's counters of it."""
    der: np.ndarray
    lens: np.ndarray
    status: np.ndarray
    rounds: int | None
    seedings: int | None


class Want(NamedTuple):
    der: np.ndarray
    lens: np.ndarray
    status: np.ndarray
    attempts: np.ndarray


def _below_n(rows: np.ndarray) -> np.ndarray:
    """[n] bool: the big-endian row is in [1, n)."""
    diff = rows.astype(np.int16) - _N_ROW.astype(np.int16)
    nz = diff != 0
    first = np.argmax(nz, axis=1)
    below = nz.any(axis=1) & (np.take_along_axis(diff, first[:, None],
                                                 1)[:, 0] < 0)
    return below & rows.any(axis=1)


def uniform_keys(gen, lanes: int) -> np.ndarray:
    """[lanes, 32] big-endian keys uniform in [1, n): rows drawn again
    where they fall outside (about 2^-128 a row)."""
    rows = gen.integers(0, 256, (lanes, 32), dtype=np.uint8)
    while True:
        bad = ~_below_n(rows)
        if not bad.any():
            return rows
        rows[bad] = gen.integers(0, 256, (int(bad.sum()), 32),
                                 dtype=np.uint8)


class Cell:
    """The traffic's ring of batches, made from the seed; the timed call,
    its control and the reference."""

    def __init__(self, config: dict, mix: dict, seed: int):
        if not config["low_r_grind"] or mix["sighash"] != \
                config["sighash_byte"]:
            raise ValueError("the cell signs as configured: low-R grinding "
                             "and the configuration's sighash byte")
        self.sighash = mix["sighash"]
        self.ring = []
        for i in range(mix["ring"]):
            gen = seeds.rng(seed, seeds.RING, i)
            self.ring.append(Batch(uniform_keys(gen, mix["lanes"]),
                                   gen.integers(0, 256, (mix["lanes"], 32),
                                                dtype=np.uint8)))
        keys = np.concatenate([b.priv for b in self.ring])
        if np.unique(keys, axis=0).shape[0] != keys.shape[0]:
            raise ValueError("a key repeats: choose another seed")

    def bind(self, device):
        """Import the program and fix the device (set-up, not timed); a
        program without the signer fails here."""
        from secp256k1_tpu_torch.models import bitcoin
        for name in ("sign_der_batch_arrays", "SignStats"):
            if not hasattr(bitcoin, name):
                raise AttributeError(f"the program has no bitcoin.{name}")
        self.bitcoin, self.device = bitcoin, device

    def _sign(self, b: Batch, grind: bool) -> Signed:
        stats = self.bitcoin.SignStats()
        der, lens, status = self.bitcoin.sign_der_batch_arrays(
            b.priv, b.digests, sighash=self.sighash, grind=grind,
            device=self.device, stats=stats)
        return Signed(der, lens, status, stats.rounds, stats.seedings)

    def call(self, b: Batch) -> Signed:
        return self._sign(b, True)

    def control(self, b: Batch) -> Signed:
        """The program's own path without Core's low-R grinding: about
        half the lanes keep a high r and differ."""
        return self._sign(b, False)

    def expected(self) -> list:
        """Each ring batch's rows, lengths, statuses (all OK) and each
        lane's attempts, by the reference; records the lanes attempted."""
        out = []
        for b in self.ring:
            keys = [int.from_bytes(r.tobytes(), "big") for r in b.priv]
            digests = [r.tobytes() for r in b.digests]
            workers = max(1, min(REFERENCE_WORKERS, os.cpu_count() or 1,
                                 b.ops // 4096))
            rows, attempts = wallet_sign.sign(keys, digests, self.sighash,
                                              True, workers)
            der = np.zeros((b.ops, DER_ROW_BYTES), np.uint8)
            lens = np.zeros(b.ops, np.int32)
            for i, row in enumerate(rows):
                der[i, :len(row)] = np.frombuffer(row, np.uint8)
                lens[i] = len(row)
            b.attempted = int(sum(attempts))
            out.append(Want(der, lens, np.zeros(b.ops, np.int32),
                            np.asarray(attempts, np.int32)))
        return out

    @staticmethod
    def mismatches(want: Want, got) -> int:
        """Lanes whose DER row (up to its length), length or status
        differs (every lane when got is no answer of the batch's shape)."""
        n = want.lens.shape[0]
        try:
            der, lens, status = (np.asarray(x) for x in got[:3])
        except (TypeError, ValueError):
            return n
        if der.shape != want.der.shape or lens.shape != (n,) \
                or status.shape != (n,):
            return n
        inside = np.arange(DER_ROW_BYTES)[None] < want.lens[:, None]
        bad = ((der != want.der) & inside).any(axis=1)
        bad |= (lens != want.lens) | (status != want.status)
        return int(bad.sum())

    @staticmethod
    def work(b: Batch) -> dict:
        if b.attempted is None:
            return {}
        return {"k_base_scan": yardstick_sign.base_scan_work(b.attempted)}
