"""State carried across from the JAX package: its limb planes and its
signed G table, as numpy arrays, to and from the port's tensors.

This system has no weights.  What the two packages share are

- limb and digit planes: numpy [L, *batch] uint32 (the JAX layout, flat
  [L, B] or tiled [L, B/128, 128], the GLV nibble digits [W, S, 128]
  among them) <-> int32 [L, B] tensors;
- point batches: the JAX `Point` (three such planes) <-> the port's;
- the partial buckets of the MSM bucket kernel: the JAX slab
  [W, nb, 3, 16, blk, 128] <-> the port's [W, nb, 3, 16, M], M = blk * 128
  (lane slot j = sublane * 128 + lane);
- the per-lane point tables of the GLV engines: the JAX
  [15, 3, 16, S, 128] (or flat [15, 3, 16, B]) <-> int32 [15, 3, 16, B];
- the G tables: numpy [W, E, 2, 16] <-> int32 tensor;
- a keyed-verify `PubkeyCache`: its affine key planes qx, qy, numpy
  [16, K] -> the port's cache.

The tests feed both packages the same inputs through these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import limbs as lb


def plane_to_torch(arr, device="cpu", dtype=lb.DTYPE) -> torch.Tensor:
    """numpy [L, *batch] (flat or tiled) -> contiguous [L, B] tensor."""
    arr = np.asarray(arr)
    flat = arr.reshape(arr.shape[0], -1)
    return torch.as_tensor(flat.astype(np.int64), device=device).to(dtype)


def plane_from_torch(t: torch.Tensor, tiled: bool = False) -> np.ndarray:
    """[L, B] tensor -> numpy uint32 [L, B], or [L, B/128, 128] if tiled."""
    arr = t.detach().cpu().numpy().astype(np.uint32)
    if tiled:
        assert arr.shape[1] % 128 == 0
        return arr.reshape(arr.shape[0], -1, 128)
    return arr


def point_to_torch(p, device="cpu"):
    """A JAX point batch (x, y, z planes, flat or tiled) -> the port's
    `Point` of int32 [16, B] planes."""
    from .ops import point as pt
    return pt.Point(*(plane_to_torch(c, device) for c in p))


def point_from_torch(p):
    """The port's `Point` -> (x, y, z) numpy uint32 [16, B] planes."""
    return tuple(plane_from_torch(c) for c in p)


def buckets_to_torch(slab, device="cpu") -> torch.Tensor:
    """JAX partial buckets [W, nb, 3, 16, blk, 128] -> int32
    [W, nb, 3, 16, blk * 128]."""
    arr = np.asarray(slab)
    flat = arr.reshape(arr.shape[:4] + (-1,))
    return torch.as_tensor(flat.astype(np.int64), device=device).to(lb.DTYPE)


def buckets_from_torch(t: torch.Tensor) -> np.ndarray:
    """int32 [W, nb, 3, 16, M] -> numpy uint32 [W, nb, 3, 16, M/128, 128]."""
    arr = t.detach().cpu().numpy().astype(np.uint32)
    assert arr.shape[-1] % 128 == 0
    return arr.reshape(arr.shape[:4] + (-1, 128))


def lane_table_to_torch(table, device="cpu") -> torch.Tensor:
    """A JAX per-lane table [15, 3, 16, *batch] (flat or tiled) ->
    contiguous int32 [15, 3, 16, B]."""
    arr = np.asarray(table)
    flat = arr.reshape(arr.shape[:3] + (-1,))
    return torch.as_tensor(flat.astype(np.int64),
                           device=device).to(lb.DTYPE).contiguous()


def lane_table_from_torch(t: torch.Tensor, tiled: bool = False):
    """int32 [15, 3, 16, B] -> numpy uint32, [15, 3, 16, B/128, 128] if
    tiled."""
    arr = t.detach().cpu().numpy().astype(np.uint32)
    if tiled:
        assert arr.shape[-1] % 128 == 0
        return arr.reshape(arr.shape[:3] + (-1, 128))
    return arr


def table_to_torch(table, device="cpu") -> torch.Tensor:
    """numpy [W, E, 2, 16] G table -> contiguous int32 tensor."""
    return torch.as_tensor(np.asarray(table).astype(np.int64),
                           device=device).to(lb.DTYPE).contiguous()


def table_from_torch(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def pubkey_cache_to_torch(qx, qy, device="cpu"):
    """The JAX package's `PubkeyCache` state, its affine planes qx, qy
    (numpy [16, K]), -> the port's `models.ecdsa.PubkeyCache` on `device`.
    The port's cache validates every key on the curve, so a key the JAX
    cache took unchecked raises here."""
    from .models import ecdsa
    xs = lb.limbs_to_int_batch(np.asarray(qx).astype(np.int64))
    ys = lb.limbs_to_int_batch(np.asarray(qy).astype(np.int64))
    return ecdsa.PubkeyCache(list(zip(xs, ys)), device=device)
