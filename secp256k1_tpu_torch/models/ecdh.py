"""Batched ECDH (SEC 1 §3.3.1): shared-secret x-coordinates (PyTorch).

The port of `secp256k1_tpu.models.ecdh`: constant-schedule GLV scalar
multiplication by the secret scalar over the whole batch (the engine the
switches of `ops/cuda/kernels.py` name, the signed one-launch kernel by
default), one shared inversion for the rescale.  Entry points run on the
GPU unless the caller passes `device="cpu"`, and raise without one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as fe
from ..ops import glv
from ..ops import limbs as lb
from ..ops import point as pt
from ..ops import s11n
from ..ops import scalar as sc
from ..utils import batching as bt
from ..utils import errors as ec
from ..utils import hostcurve as hc


def _ecdh_core(k, px, py):
    """k * (px, py) for canonical scalar and affine point planes: (shared
    x bytes [32, B], identity flags [B])."""
    p = pt.Point(px, py, fe.one(px.shape[1:], px.device))
    shared = glv.scalar_mult(k, p)
    aff = pt.to_affine(shared)
    return fe.to_bytes(aff.x), pt.is_identity(shared)


def ecdh_batch(privs, pubs, device=None) -> list:
    """Shared secrets for the pairs (privs[i], pubs[i]) of
    `keys.PrivateKey` and `keys.PublicKey`; returns [bytes]."""
    device = bt.resolve_device(device)
    n = len(privs)
    b = bt.bucket(n)
    k = bt.plane([p.scalar for p in privs], b, fill=1, device=device)
    px = bt.plane([p.point[0] for p in pubs], b, fill=hc.GX, device=device)
    py = bt.plane([p.point[1] for p in pubs], b, fill=hc.GY, device=device)
    xb, ident = _ecdh_core(k, px, py)
    assert not any(bt.unplane_flags(ident, n)), "ECDH result is identity"
    return bt.unplane_bytes(xb, n)


def _ecdh_e2e_core(k_bytes, want_odd, pub_x_bytes):
    """ECDH from raw byte planes on the device: scalar range, SEC1
    compressed key lift, GLV scalar multiplication and the affine x, with
    no per-lane host arithmetic.  Returns (x bytes [32, B], status [B]):
    a key that does not lift, or an identity result, gives
    ERR_INVALID_PUBLIC_KEY; k not in [1, n) ERR_INVALID_SCALAR (such lanes
    run with k = 1)."""
    k = sc.S._bytes_to_limbs(k_bytes)
    bad_k = lb.geq_const(k, sc.S.m_limbs) | lb.is_zero(k)
    k_safe = lb.select(~bad_k, k, sc.S.one(k.shape[1:], k.device))
    pub, pub_status = s11n.decompress(want_odd, pub_x_bytes)
    shared = glv.scalar_mult(k_safe.to(lb.DTYPE), pub)
    ident = pt.is_identity(shared)
    aff = pt.to_affine(shared)
    st = torch.where(
        pub_status != ec.OK, ec.ERR_INVALID_PUBLIC_KEY,
        torch.where(bad_k, ec.ERR_INVALID_SCALAR,
                    torch.where(ident, ec.ERR_INVALID_PUBLIC_KEY, ec.OK)))
    return fe.to_bytes(aff.x), st.to(torch.int32)


def ecdh_batch_arrays(priv_bytes: np.ndarray, pubs_sec1: np.ndarray,
                      chunk_lanes: int | None = None, device=None):
    """End-to-end batched ECDH on numpy arrays.

    priv_bytes: [n, 32] u8 big-endian scalars; pubs_sec1: [n, 33] u8
    SEC1-compressed public keys.  Host work is the one-byte prefix check;
    decompression and the group math run on the device.  Returns (shared
    [n, 32] u8 x-coordinates, status [n] int32); failed lanes get zeroed
    output.  chunk_lanes: cut the batch into chunks of this many lanes,
    dispatched back to back.  device: None (the GPU) or a torch device."""
    device = bt.resolve_device(device)
    n = priv_bytes.shape[0]
    if priv_bytes.shape != (n, 32) or pubs_sec1.shape != (n, 33):
        raise ValueError(f"expected [n, 32] keys and [n, 33] public keys, "
                         f"got {priv_bytes.shape} and {pubs_sec1.shape}")
    prefix = pubs_sec1[:, 0]
    bad_prefix = (prefix != 0x02) & (prefix != 0x03)

    def dispatch(lo, hi):
        b = bt.bucket(hi - lo)
        want_odd = bt.scalar_plane(prefix[lo:hi] == 0x03, b, fill=False,
                                   dtype=torch.bool, device=device)
        return _ecdh_e2e_core(
            bt.byte_plane_np(priv_bytes[lo:hi], b, device), want_odd,
            bt.byte_plane_np(pubs_sec1[lo:hi, 1:], b, device))

    chunk_lanes = bt.auto_chunk(n, chunk_lanes)
    if chunk_lanes is None or n <= chunk_lanes:
        spans = [(0, n)]
    else:
        spans = [(lo, min(lo + chunk_lanes, n))
                 for lo in range(0, n, chunk_lanes)]
    outs = [dispatch(lo, hi) for lo, hi in spans]
    shared = np.concatenate(
        [x.cpu().numpy().astype(np.uint8).reshape(32, -1)[:, :hi - lo].T
         for (x, _), (lo, hi) in zip(outs, spans)])
    status = np.concatenate(
        [st.cpu().numpy().reshape(-1)[:hi - lo]
         for (_, st), (lo, hi) in zip(outs, spans)]).astype(np.int32)
    status = np.where(bad_prefix, ec.ERR_INVALID_PUBLIC_KEY, status)
    shared = np.ascontiguousarray(shared)
    shared[status != ec.OK] = 0
    return shared, status.astype(np.int32)
