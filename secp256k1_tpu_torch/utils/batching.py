"""Host <-> device batch marshalling for the port.

Planes are flat: [16, B] int32 limb planes, [W, B] uint8 byte planes and [B]
scalar planes, on an explicit device.  The JAX package's [16, S, 128] tiling
and 1024-lane padding are TPU layout and have no counterpart here; a batch
is padded to a power of two only to keep shapes few.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import limbs as lb


def resolve_device(device=None) -> torch.device:
    """None means the GPU.  Raises when the GPU is asked for and missing:
    the port never carries on on the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def bucket(n: int, min_bucket: int = 16, max_bucket: int = 1 << 20) -> int:
    """Padded batch size for n lanes: a power of two, at least min_bucket.
    Raises when n exceeds max_bucket (callers chunk instead)."""
    if n > max_bucket:
        raise ValueError(
            f"batch of {n} lanes exceeds max_bucket={max_bucket}; "
            "chunk the input (e.g. chunk_lanes) instead")
    b = min_bucket
    while b < n:
        b <<= 1
    return b


def auto_chunk(n: int, chunk_lanes: int | None,
               max_bucket: int = 1 << 20) -> int | None:
    """Keep an explicit chunk_lanes, else chunk at max_bucket when n
    exceeds a single launch."""
    if chunk_lanes is None and n > max_bucket:
        return max_bucket
    return chunk_lanes


def batch_shape(b: int) -> tuple:
    """The batch shape of b lanes: (b,), the layout of every plane here
    (the JAX package's is (b // 128, 128) while its Pallas kernels are
    on)."""
    return (b,)


def pad_vals(vals, b, fill):
    return list(vals) + [fill] * (b - len(vals))


def plane(ints, b: int, fill: int = 0, device=None) -> torch.Tensor:
    """List of ints -> [16, b] int32 plane on `device`."""
    arr = lb.int_to_limbs_batch(pad_vals(ints, b, fill))
    return torch.as_tensor(arr, dtype=lb.DTYPE, device=resolve_device(device))


def scalar_plane(vals, b: int, fill=0, dtype=torch.int32,
                 device=None) -> torch.Tensor:
    """List or array of scalars -> [b] tensor on `device`."""
    arr = np.asarray(vals)
    if arr.shape[0] < b:
        arr = np.concatenate(
            [arr, np.full((b - arr.shape[0],), fill, dtype=arr.dtype)])
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))


def byte_plane(chunks, b: int, fill: bytes | None = None,
               device=None) -> torch.Tensor:
    """List of equal-width byte strings -> [W, b] uint8 plane on `device`;
    lanes past the list take `fill` (zeros by default)."""
    w = len(chunks[0]) if chunks else len(fill)
    if fill is None:
        fill = b"\x00" * w
    arr = np.frombuffer(b"".join(pad_vals(chunks, b, fill)), np.uint8)
    return torch.as_tensor(np.ascontiguousarray(arr.reshape(b, w).T),
                           device=resolve_device(device))


def byte_plane_np(arr: np.ndarray, b: int, device=None) -> torch.Tensor:
    """[n, W] u8 numpy array -> [W, b] uint8 plane on `device`; lanes past
    n repeat the last row (keeps the padded batch well-formed)."""
    n, w = arr.shape
    assert n <= b
    if n < b:
        arr = np.concatenate([arr, np.repeat(arr[-1:], b - n, axis=0)], 0)
    return torch.as_tensor(np.ascontiguousarray(arr.T),
                           device=resolve_device(device))


def unplane_ints(x: torch.Tensor, n: int) -> list:
    """[16, B] plane -> first n ints."""
    return lb.limbs_to_int_batch(x.reshape(16, -1)[:, :n])


def unplane_bytes(x: torch.Tensor, n: int) -> list:
    """[W, B] byte plane -> first n byte strings."""
    arr = x.cpu().numpy().astype(np.uint8).reshape(x.shape[0], -1)
    return [arr[:, i].tobytes() for i in range(n)]


def unplane_flags(x: torch.Tensor, n: int) -> list:
    """[B] plane -> first n python scalars."""
    return x.reshape(-1)[:n].cpu().tolist()
