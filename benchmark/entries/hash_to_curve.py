"""RFC 9380 hash-to-curve, suite `secp256k1_XMD:SHA-256_SSWU_RO_`, through
`models.h2c.hash_to_curve_batch_arrays` over messages of mixed length:
zero-padded rows and their lengths in; affine points (x || y) and the
identity flags out.

Configuration keys: `dst`.  Traffic keys: `lanes` a call, `ring`
(batches cycled through in the window), `min_len` and `max_len` (message
lengths drawn evenly between them), `long_len` and `long_share` (the
share of lanes whose message is `long_len` bytes), `planted` (messages put
at seeded lanes of every batch: the suite's J.8.1 vectors).
"""

from __future__ import annotations

import inspect
import os
from typing import NamedTuple

import numpy as np

import seeds
from reference import h2c

# The number the check compares, with the limit 0.
CHECK = "point_mismatches"
# Messages up to this length are made distinct across the ring by drawing
# again; longer ones repeat with a chance below 2^-50.
DISTINCT_UPTO = 8
# The reference splits the ring over this many processes at most, one a
# 4,096 messages.
REFERENCE_WORKERS = 8
# The port's functions the traced run wraps: (module, name, device span).
SPANS = (
    ("secp256k1_tpu_torch.models.h2c", "expand_message_xmd_batch", False),
    ("secp256k1_tpu_torch.models.h2c", "_ro_bytes_core", True),
)


class Batch:
    def __init__(self, msgs, lens, long_lanes, planted):
        self.msgs, self.lens = msgs, lens
        self.long_lanes = long_lanes      # lanes of `long_len` bytes
        self.planted = planted            # lane of each planted message
        self.ops = msgs.shape[0]


class Hashed(NamedTuple):
    """A call's answer and the program's count of its host compressions."""
    points: np.ndarray
    ident: np.ndarray
    host_blocks: int | None


def _distinct(rows: np.ndarray, lens: np.ndarray, gen) -> None:
    """Draw again the messages of 2 to DISTINCT_UPTO bytes that repeat,
    until none does (0- and 1-byte messages cannot all differ)."""
    for n in range(2, DISTINCT_UPTO + 1):
        lanes = np.nonzero(lens == n)[0]
        while lanes.size:
            _, first = np.unique(rows[lanes, :n], axis=0, return_index=True)
            again = np.setdiff1d(np.arange(lanes.size), first)
            if not again.size:
                break
            rows[lanes[again], :n] = gen.integers(0, 256, (again.size, n),
                                                  dtype=np.uint8)


def make_ring(mix: dict, seed: int) -> list:
    """The ring's batches: lengths and bytes from the pool's stream, the
    long and planted lanes of each batch from its own."""
    lanes, ring = mix["lanes"], mix["ring"]
    planted = [m.encode() for m in mix["planted"]]
    width = max([mix["max_len"], mix["long_len"]]
                + [len(m) for m in planted])
    gen = seeds.rng(seed, seeds.POOL)
    lens = gen.integers(mix["min_len"], mix["max_len"] + 1, lanes * ring)
    n_long = max(1, round(lanes * mix["long_share"]))
    picks = [seeds.rng(seed, seeds.RING, i).choice(
        lanes, n_long + len(planted), replace=False) for i in range(ring)]
    for i, p in enumerate(picks):
        lens[i * lanes + p[:n_long]] = mix["long_len"]
    rows = gen.integers(0, 256, (lanes * ring, width), dtype=np.uint8)
    _distinct(rows, lens, gen)
    for i, p in enumerate(picks):
        for lane, m in zip(p[n_long:], planted):
            rows[i * lanes + lane, :len(m)] = np.frombuffer(m, np.uint8)
            lens[i * lanes + lane] = len(m)
    rows[np.arange(width) >= lens[:, None]] = 0
    lens = lens.astype(np.int32)
    return [Batch(rows[i * lanes:(i + 1) * lanes], lens[i * lanes:
                                                       (i + 1) * lanes],
                  p[:n_long], p[n_long:]) for i, p in enumerate(picks)]


class Cell:
    """The ring of batches, made from the seed; the timed call, its
    control and the reference."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.dst = config["dst"].encode()
        self.ring = make_ring(mix, seed)

    def bind(self, device):
        """Import the program and fix the device (set-up, not timed); a
        program whose arrays entry takes no per-lane lengths fails here."""
        from secp256k1_tpu_torch.models import h2c as ph2c
        params = inspect.signature(ph2c.hash_to_curve_batch_arrays).parameters
        if "lens" not in params:
            raise TypeError("the program's h2c.hash_to_curve_batch_arrays "
                            "takes no per-lane lengths (lens)")
        self.h2c, self.device = ph2c, device

    def _hash(self, b: Batch, lens) -> Hashed:
        counter = getattr(self.h2c, "XMD_HOST_BLOCKS", None)
        before = None if counter is None else counter["blocks"]
        points, ident = self.h2c.hash_to_curve_batch_arrays(
            b.msgs, self.dst, lens, device=self.device)
        return Hashed(points, ident,
                      None if counter is None else counter["blocks"] - before)

    def call(self, b: Batch) -> Hashed:
        return self._hash(b, b.lens)

    def control(self, b: Batch) -> Hashed:
        """The program's own path with the lengths dropped: every row
        hashed whole, so every lane shorter than its row differs."""
        return self._hash(b, None)

    def expected(self) -> list:
        """Each ring batch's (points, identity flags), by the reference."""
        rows = np.concatenate([b.msgs for b in self.ring])
        lens = np.concatenate([b.lens for b in self.ring])
        workers = max(1, min(REFERENCE_WORKERS, os.cpu_count() or 1,
                             rows.shape[0] // 4096))
        pts, ident = h2c.points(rows, lens, self.dst, workers)
        return list(zip(np.split(pts, len(self.ring)),
                        np.split(ident, len(self.ring))))

    @staticmethod
    def mismatches(want, got) -> int:
        """Lanes whose identity flag, or whose 64-byte x || y where it is
        no identity, differs (every lane when the answer has not the
        batch's shapes)."""
        w_pts, w_ident = want
        pts = np.asarray(getattr(got, "points", None))
        ident = np.asarray(getattr(got, "ident", None))
        if pts.shape != w_pts.shape or ident.shape != w_ident.shape:
            return int(w_ident.size)
        bad = (ident.astype(bool) != w_ident) \
            | (~w_ident & (pts != w_pts).any(axis=1))
        return int(bad.sum())

    @staticmethod
    def work(b: Batch) -> dict:
        return {}
