"""Process groups, the `data` mesh and batch sharding on `torch.distributed`.

The port of `secp256k1_tpu.parallel.mesh`.  PyTorch runs one process per
device where JAX runs one controller over many: every rank calls the same
functions, the `data` mesh spans the world's ranks, and a rank holds the
contiguous slice of the lane axis that its rank number picks.  The lane
axis is the last axis of a tensor: axis 1 of a [16, B] plane, the only
axis of a [B] status plane.  The backend follows the device: NCCL for
CUDA, gloo for the CPU.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import point as pt
from ..utils import batching as bt

# The host group of `barrier`, made once beside each default group.
_BARRIER_GROUPS: dict = {}


def init_distributed(device=None, **kwargs) -> None:
    """Join this process to the world: `torch.distributed.init_process_group`
    with `kwargs` as given (`init_method`, `world_size`, `rank`, ...).
    `device` (None: the GPU, which must be present) picks the backend
    unless `kwargs` names one, NCCL for CUDA and gloo for the CPU, and a
    CUDA device with an index becomes the current one.  A failed NCCL
    start raises; nothing falls back to gloo."""
    dev = bt.resolve_device(device)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(**kwargs)


def data_mesh(n_devices: int | None = None) -> DeviceMesh:
    """The 1-D mesh `("data",)` over every rank of the world, on the
    backend's device type.  Raises when no process group is initialized
    (no world of one is made silently) and when `n_devices` is given and is
    not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh: no process group: call "
                           "init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data_mesh: n_devices={n_devices}, but the world "
                         f"has {world} ranks (one device a rank)")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=("data",))


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Host barrier of every rank: `monitored_barrier` on a gloo group made
    once beside the default group, never a device collective, so ranks may
    arrive any time apart within `timeout_s` (one may still be building its
    kernels).  Its error names the barrier.  No-op without a process
    group."""
    if not dist.is_initialized():
        return
    world = dist.group.WORLD
    if world not in _BARRIER_GROUPS:
        _BARRIER_GROUPS[world] = dist.new_group(backend="gloo")
    try:
        dist.monitored_barrier(_BARRIER_GROUPS[world],
                               timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r} failed: {exc}") from exc


def _device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map(fn, tree):
    if isinstance(tree, pt.Point):
        return pt.Point(*(fn(c) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, c) for c in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's slice of a tensor, numpy array, `Point` or tuple or list
    of them: every rank passes the whole batch, and gets the contiguous
    slice of the lane axis (the last) that its rank picks, on its device.
    Raises when the lanes are not a multiple of the mesh size."""
    n_shards, rank = mesh.size(), mesh.get_local_rank("data")
    dev = _device(mesh)

    def put(x):
        x = torch.as_tensor(x)
        lanes = x.shape[-1]
        if lanes % n_shards:
            raise ValueError(f"shard_batch: {lanes} lanes do not split "
                             f"over {n_shards} ranks")
        step = lanes // n_shards
        return x[..., rank * step:(rank + 1) * step].contiguous().to(dev)
    return _map(put, tree)


def all_gather(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x, stacked by rank: [D, *x.shape] on every rank (the
    list form of `dist.all_gather`, which both gloo and NCCL take)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.stack(parts)


def gather_batch(mesh: DeviceMesh, tree):
    """The inverse of `shard_batch`: every rank's slices joined along the
    lane axis, on every rank (what reading a sharded JAX array does)."""
    return _map(lambda x: torch.cat(tuple(all_gather(mesh, x)), -1), tree)
