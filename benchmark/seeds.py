"""Seeded random streams: one per purpose, so that adding a draw to one
never moves another."""

from __future__ import annotations

import numpy as np

POOL, RING = 1, 2


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """The generator of `stream` (and `index` within it) for `seed`, any
    whole number."""
    return np.random.default_rng([seed & (2**64 - 1), stream, index])


def scalar(gen: np.random.Generator, low: int, high: int) -> int:
    """A python int in [low, high) from 40 bytes of the stream."""
    return low + int.from_bytes(gen.bytes(40), "big") % (high - low)
