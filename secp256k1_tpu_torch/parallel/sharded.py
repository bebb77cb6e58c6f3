"""Sharded pipelines: data-parallel batch verify and sharded Pippenger MSM.

The port of `secp256k1_tpu.parallel.sharded`, one process per device:

- **Batch verify** is data-parallel: each rank verifies its slice of the
  lanes (`mesh.shard_batch`) with `ecdsa._verify_core` and keeps its
  statuses; no collective.  `mesh.gather_batch` reads every lane's.
- **Pippenger MSM**: each rank runs bucket accumulation and the weighted
  bucket sums on its slice of the points (`msm.pippenger_window_sums`,
  [W, 3, 16] window sums), the window sums of all ranks are all-gathered
  ([D, W, 3, 16], W x 192 bytes a rank), reduced over D by a log-depth
  tree of batched `point.add` (`_tree_reduce`), and every rank runs the
  Horner window fold (`msm.combine_windows`).

The JAX `_jit` functions and their caches have no counterpart: eager
PyTorch compiles nothing, and the kernels are built once a process.
"""

from __future__ import annotations

import torch

from ..models.ecdsa import _verify_core
from ..ops import msm as msm_ops
from ..ops import point as pt
from .mesh import all_gather


def sharded_verify_fn(mesh):
    """The data-parallel ECDSA verify core: f(qx, qy, e, r, s) on this
    rank's slices ([16, B / D] planes from `shard_batch`) returns this
    rank's int32 statuses [B / D], as JAX keeps them sharded."""
    def f(qx, qy, e, r, s):
        return _verify_core(qx, qy, e, r, s)
    return f


def _tree_reduce(gathered):
    """[D, W, 3, 16] window sums of D shards -> [W, 3, 16]: pairwise levels
    of one batched `point.add` each, the first half of the shards plus the
    second half, an odd last shard carried to the next level.  The JAX
    order exactly, so X, Y, Z equal the JAX package's."""
    d = gathered.shape[0]
    while d > 1:
        half = d // 2
        rows = gathered.shape[1:]
        summed = msm_ops._rows_add(gathered[:half].reshape(-1, 3, 16),
                                   gathered[half:2 * half].reshape(-1, 3, 16))
        merged = summed.reshape((half,) + rows)
        if d % 2:
            merged = torch.cat([merged, gathered[2 * half:]], 0)
        gathered = merged
        d = gathered.shape[0]
    return gathered[0]


def sharded_msm(mesh, scalars, points: pt.Point,
                window_bits: int = 8) -> pt.Point:
    """sum_i k_i * P_i over the points of every rank: scalars [16, N / D]
    and points Point (N / D,), this rank's slice (`shard_batch`).  Every
    rank returns the same one-lane Point.  The default w = 8 takes the
    sort + scan path of `pippenger_window_sums`; w = 4 on slices of 2,048
    points or more (a multiple of 1,024) the bucket kernel."""
    local_fn, combine_fn = sharded_msm_split(mesh, window_bits)
    return combine_fn(local_fn(scalars, points))


def sharded_msm_split(mesh, window_bits: int = 8):
    """(local_fn, combine_fn), the two stages of `sharded_msm`, to time
    them apart: local_fn(scalars, points) on this rank's slice -> its
    window sums [W, 3, 16]; combine_fn(wsums) -> the all-gather, the tree
    over the ranks and the window fold, the same Point on every rank.
    Composed they are `sharded_msm`."""
    def local_fn(scalars, points):
        return msm_ops.pippenger_window_sums(scalars, points, window_bits)

    def combine_fn(wsums):
        return msm_ops.combine_windows(_tree_reduce(all_gather(mesh, wsums)),
                                       window_bits)
    return local_fn, combine_fn
