"""BIP-0340 batch verification's multi-scalar multiplication through
`ops.msm.multi_scalar_mult` (automatic window).  The points (64-byte affine
x || y rows) stay on the card as byte planes from set-up, as a verifier's
key cache holds them: the pool's rows are uploaded once and each batch's
planes gathered from them there.  The scalars (32-byte big-endian rows)
are new in every batch and come from the host in each timed call: the rows,
staged in page-locked memory, are copied to the card as they lie and
turned into byte planes there; the call then decodes (`ops.s11n.decode_uncompressed`, the scalar ring's
`from_bytes_any`), runs the MSM and reads the sum back as
`ops.s11n.uncompressed_bytes`.

Configuration keys: `distinct_points` (the seeded pool of points a_j G).
Traffic keys: `lanes` (points a call, a multiple of the pool) and `ring`
(distinct batches cycled through in the window).  Scalars are uniform in
[0, n) and fresh in every batch.
"""

from __future__ import annotations

import numpy as np

import seeds
import yardstick
from reference import curve, msm

# The number the check compares, with the limit 0.
CHECK = "sum_mismatches"
CHAINS = 256
SPANS = (
    ("secp256k1_tpu_torch.ops.msm", "pippenger_window_sums", True),
    ("secp256k1_tpu_torch.ops.msm", "combine_windows", True),
    ("secp256k1_tpu_torch.ops.s11n", "decode_uncompressed", False),
    ("secp256k1_tpu_torch.ops.s11n", "uncompressed_bytes", False),
)
_N_BYTES = np.frombuffer(curve.N.to_bytes(32, "big"), np.uint8)


def uniform_scalars(gen, lanes: int) -> np.ndarray:
    """[lanes, 32] u8 big-endian scalars uniform in [0, n)."""
    out = gen.integers(0, 256, (lanes, 32), dtype=np.uint8)
    while True:
        diff = out.astype(np.int16) - _N_BYTES
        first = np.argmax(diff != 0, axis=1)
        lead = diff[np.arange(lanes), first]
        high = np.nonzero(lead >= 0)[0]          # >= n, or equal to n
        if not high.size:
            return out
        out[high] = gen.integers(0, 256, (high.size, 32), dtype=np.uint8)


class Batch:
    """A call's scalar rows, and `src`, the pool point of each lane."""

    def __init__(self, src, scalars):
        self.src, self.scalars = src, scalars
        self.ops = scalars.shape[0]


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.comb = curve.Comb()
        gen = seeds.rng(seed, seeds.POOL)
        size = config["distinct_points"]
        self.logs, pts = curve.progression(
            self.comb, [seeds.scalar(gen, 1, curve.N) for _ in range(CHAINS)],
            seeds.scalar(gen, 1, curve.N), size)
        rows = np.frombuffer(bytearray(b"".join(curve.uncompressed(q)[1:]
                                                for q in pts)), np.uint8)
        self.pool_rows = rows.reshape(size, 64)
        lanes = mix["lanes"]
        if lanes % size:
            raise ValueError(f"lanes {lanes} is not a multiple of the pool "
                             f"{size}")
        self.ring = []
        for i in range(mix["ring"]):
            g = seeds.rng(seed, seeds.RING, i)
            src = g.permutation(np.tile(np.arange(size), lanes // size))
            self.ring.append(Batch(src, uniform_scalars(g, lanes)))

    def bind(self, device):
        """Import the program, put each batch's point planes on the device
        and its scalar rows in page-locked host memory, where a batch
        verifier stages what it uploads (set-up, not timed)."""
        import torch

        from secp256k1_tpu_torch.ops import msm, s11n, scalar
        self.msm, self.s11n, self.scalar = msm, s11n, scalar
        self.device = device
        pinned = torch.device(device).type == "cuda"
        pool = torch.from_numpy(self.pool_rows).to(device)
        for b in self.ring:
            src = torch.from_numpy(b.src).to(device)
            b.xy_plane = pool.index_select(0, src).T.contiguous()
            b.k_rows = torch.from_numpy(b.scalars)
            if pinned:
                b.k_rows = b.k_rows.pin_memory()

    def _sum(self, k_rows, xy_plane) -> np.ndarray:
        """The program's path from the scalars' host rows: their upload
        and byte planes, then 65 bytes of the sum, its identity flag and
        the count of points that failed to decode, in one read-back."""
        import torch
        k_plane = k_rows.to(self.device, non_blocking=True).T.contiguous()
        pts, status = self.s11n.decode_uncompressed(xy_plane[:32],
                                                    xy_plane[32:])
        k, _ = self.scalar.from_bytes_any(k_plane)
        total = self.msm.multi_scalar_mult(k, pts)
        enc, ident = self.s11n.uncompressed_bytes(total)
        bad = (status != 0).sum().reshape(1)
        return torch.cat([enc.reshape(-1).to(torch.int64),
                          ident.reshape(-1).to(torch.int64), bad]).cpu().numpy()

    def call(self, b: Batch) -> np.ndarray:
        return self._sum(b.k_rows, b.xy_plane)

    def control(self, b: Batch) -> np.ndarray:
        """The program's path over scalars cut to 252 bits (the top window
        dropped): a sum that leaves part of the work out."""
        import torch
        cut = b.scalars.copy()
        cut[:, 0] &= 0x0F
        return self._sum(torch.from_numpy(cut), b.xy_plane)

    def expected(self) -> list:
        out = []
        for b in self.ring:
            enc = msm.expected_sum(b.scalars, b.src, self.logs, self.comb)
            ident = int(enc == b"\x00")
            row = np.zeros(65, np.int64) if ident else np.frombuffer(
                enc, np.uint8).astype(np.int64)
            out.append(np.concatenate([row, [ident, 0]]))
        return out

    @staticmethod
    def mismatches(want: np.ndarray, got) -> int:
        """1 where the sum, its identity flag or the decode count differs."""
        got = np.asarray(got)
        return int(got.shape != want.shape or bool((got != want).any()))

    @staticmethod
    def work(b: Batch) -> dict:
        return {"k_msm_buckets": yardstick.msm_buckets_work(b.scalars)}
