"""Batched ECDSA verify (SEC 1 4.1.4) on PyTorch.

The port of the verify path of `secp256k1_tpu.models.ecdsa`: the host
parses signatures; decompression, hash-to-scalar reduction, batch
inversion and the group math run on the device, through the five CUDA
kernels of `ops/cuda` when the device is a GPU.

Entry points (`verify_batch_arrays`, `verify_raw_batch_status`) take
`device=None`, which means the GPU, and raise when there is none; the CPU
runs only when the caller passes `device="cpu"`.
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
from . import codecs

N = hc.N
_N_LIMBS = lb.int_to_limbs(N)
_P17_LIMBS = lb.int_to_limbs(hc.P, 17)


def _status_where(cond, code, other):
    return torch.where(cond, torch.as_tensor(code, dtype=torch.int32,
                                             device=other.device), other)


def _verify_impl(qx, qy, e, r, s):
    """SEC1 4.1.4 steps 1-8 for a whole batch: returns an int32 status
    plane.  The final comparison is projective: x_R = r (mod n) with
    x_R < p iff X == r*Z or X == (r+n)*Z (mod p), the latter only when
    r + n < p.  Identity R is rejected first, so Z != 0."""
    bad_rs = sc.is_zero(r) | sc.is_zero(s)
    s_inv = sc.invert_auto(s)
    u1 = sc.mul(e, s_inv)
    u2 = sc.mul(r, s_inv)
    q = pt.Point(qx, qy, fe.one(qx.shape[1:], qx.device))
    big_r = glv.double_scalar_mult_basepoint(u1, u2, q)
    is_inf = pt.is_identity(big_r)

    match1 = fe.eq(big_r.x, fe.mul(r, big_r.z))
    n17 = lb.add(r, lb.const_plane(_N_LIMBS, r), 17)
    fits = ~lb.geq_const(n17, _P17_LIMBS)
    match2 = fe.eq(big_r.x, fe.mul(n17[:16], big_r.z)) & fits
    mismatch = ~(match1 | match2)
    st = torch.full(bad_rs.shape, ec.OK, dtype=torch.int32,
                    device=bad_rs.device)
    st = _status_where(mismatch, ec.ERR_V_NEQ_R, st)
    st = _status_where(is_inf, ec.ERR_R_IS_INFINITY, st)
    return _status_where(bad_rs, ec.ERR_INVALID_SIGNATURE, st)


def _finish(st, pub_status, s, reject_malleable, host_status):
    st = _status_where(pub_status != ec.OK, ec.ERR_INVALID_PUBLIC_KEY, st)
    if reject_malleable:
        st = _status_where(sc.is_greater_than_half_n(s), ec.ERR_MALLEABLE,
                           st)
    if host_status is not None:
        st = torch.where(host_status != ec.OK, host_status.to(torch.int32),
                         st)
    return st


def _scalars(e_bytes, r_bytes, s_bytes):
    e, _ = sc.S.from_bytes_any(e_bytes)
    r = sc.S._bytes_to_limbs(r_bytes).to(lb.DTYPE)   # parser: [1, n)
    s = sc.S._bytes_to_limbs(s_bytes).to(lb.DTYPE)
    return e, r, s


def _verify_e2e_core(want_odd, pub_x_bytes, e_bytes, r_bytes, s_bytes,
                     reject_malleable=False, host_status=None):
    """Verify from raw byte planes with SEC1-compressed keys: decompress,
    reduce the digest, optional low-s rejection, then the SEC1 core.
    `host_status` (parse failures) takes precedence."""
    pub, pub_status = s11n.decompress(want_odd, pub_x_bytes)
    e, r, s = _scalars(e_bytes, r_bytes, s_bytes)
    st = _verify_impl(pub.x, pub.y, e, r, s)
    return _finish(st, pub_status, s, reject_malleable, host_status)


def _verify_e2e_mixed_core(want_odd, is_unc, x_bytes, y_bytes, e_bytes,
                           r_bytes, s_bytes, reject_malleable=False,
                           host_status=None):
    """`_verify_e2e_core` with per-lane SEC1 encodings: lanes with is_unc
    take the uncompressed decode, others decompress from x.  Both decodes
    run on every lane (uniform schedule); the result is a per-lane
    select."""
    pub_c, st_c = s11n.decompress(want_odd, x_bytes)
    pub_u, st_u = s11n.decode_uncompressed(x_bytes, y_bytes)
    pub = pt.select(is_unc, pub_u, pub_c)
    pub_status = torch.where(is_unc, st_u, st_c)
    e, r, s = _scalars(e_bytes, r_bytes, s_bytes)
    st = _verify_impl(pub.x, pub.y, e, r, s)
    return _finish(st, pub_status, s, reject_malleable, host_status)


# ---------------------------------------------------------------------------
# Host helpers.
# ---------------------------------------------------------------------------

def hash_to_scalar_int(digest: bytes) -> int:
    """Leftmost 256 bits of the digest, reduced mod n."""
    if len(digest) < 32:
        raise ValueError("invalid digest")
    return int.from_bytes(digest[:32], "big") % N


def _parse_sigs_host(sigs: np.ndarray, lens: np.ndarray, n: int):
    """Strict-DER parse of every row: (r_arr [n, 32] u8, s_arr [n, 32] u8,
    host_status [n] int32), no key checks and no inert fill."""
    r_arr = np.zeros((n, 32), np.uint8)
    s_arr = np.zeros((n, 32), np.uint8)
    host_status = np.zeros((n,), np.int32)
    for i in range(n):
        try:
            r, s = codecs.parse_asn1_signature(sigs[i, :lens[i]].tobytes())
            r_arr[i] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
            s_arr[i] = np.frombuffer(s.to_bytes(32, "big"), np.uint8)
        except codecs.ScalarError:
            host_status[i] = ec.ERR_INVALID_SCALAR
        except codecs.CodecError:
            host_status[i] = ec.ERR_INVALID_ENCODING
    return r_arr, s_arr, host_status


def _inert_fill(r_arr, s_arr, host_status):
    """Failed lanes get inert device inputs (r = s = 1)."""
    one32 = np.zeros((32,), np.uint8)
    one32[31] = 1
    bad = host_status != ec.OK
    return (np.where(bad[:, None], one32[None], r_arr),
            np.where(bad[:, None], one32[None], s_arr))


def _e2e_host_parse(pubs_sec1: np.ndarray, sigs: np.ndarray,
                    lens: np.ndarray):
    """Host stage: strict-DER parse and key prefix checks.  In a 65-byte
    wide batch a compressed key's 32 pad bytes must be zero (the JAX
    package ignores them); a lane that breaks that fails with
    ERR_INVALID_PUBLIC_KEY."""
    n = pubs_sec1.shape[0]
    r_arr, s_arr, host_status = _parse_sigs_host(sigs, lens, n)
    prefix = pubs_sec1[:, 0]
    bad_prefix = (prefix != 0x02) & (prefix != 0x03)
    if pubs_sec1.shape[1] == 65:
        bad_prefix &= prefix != 0x04
        bad_prefix |= (prefix != 0x04) & pubs_sec1[:, 33:].any(axis=1)
    host_status = np.where(
        bad_prefix & (host_status == ec.OK),
        ec.ERR_INVALID_PUBLIC_KEY, host_status).astype(np.int32)
    r_arr, s_arr = _inert_fill(r_arr, s_arr, host_status)
    return r_arr, s_arr, host_status


def _e2e_dispatch(pubs_sec1, digests, r_arr, s_arr, host_status,
                  reject_malleable, device):
    """Marshal one chunk to planes on `device` and run the device stage
    (asynchronous on a GPU: returns the status tensor)."""
    n = pubs_sec1.shape[0]
    b = bt.bucket(n)
    prefix = pubs_sec1[:, 0]
    want_odd = bt.scalar_plane(prefix == 0x03, b, fill=False,
                               dtype=torch.bool, device=device)
    host = bt.scalar_plane(host_status, b, device=device)
    if pubs_sec1.shape[1] == 65:
        is_unc = bt.scalar_plane(prefix == 0x04, b, fill=False,
                                 dtype=torch.bool, device=device)
        return _verify_e2e_mixed_core(
            want_odd, is_unc, bt.byte_plane_np(pubs_sec1[:, 1:33], b, device),
            bt.byte_plane_np(pubs_sec1[:, 33:65], b, device),
            bt.byte_plane_np(digests, b, device),
            bt.byte_plane_np(r_arr, b, device),
            bt.byte_plane_np(s_arr, b, device), reject_malleable, host)
    return _verify_e2e_core(
        want_odd, bt.byte_plane_np(pubs_sec1[:, 1:], b, device),
        bt.byte_plane_np(digests, b, device),
        bt.byte_plane_np(r_arr, b, device),
        bt.byte_plane_np(s_arr, b, device), reject_malleable, host)


# ---------------------------------------------------------------------------
# Batched public API.
# ---------------------------------------------------------------------------

def verify_batch_arrays(pubs_sec1: np.ndarray, digests: np.ndarray,
                        sigs: np.ndarray, lens: np.ndarray | None = None,
                        reject_malleable: bool = False,
                        chunk_lanes: int | None = None,
                        pub_lens: np.ndarray | None = None,
                        device=None) -> np.ndarray:
    """End-to-end batched ECDSA verify on numpy arrays.

    pubs_sec1: [n, 33] u8 SEC1-compressed keys, or [n, 65] u8 with per-lane
    encodings (0x02/0x03 compressed with 32 zero pad bytes, 0x04
    uncompressed); digests: [n, D] u8 with D >= 32, of which the leftmost
    256 bits are used; sigs: [n, max_len] u8 zero-padded DER; lens: [n]
    actual lengths (None = every row is max_len).  Returns an [n] int32
    status array (`utils.errors` codes).

    chunk_lanes: cut the batch into chunks of this many lanes, dispatched
    back to back.  pub_lens: optional [n] actual key lengths; a lane whose
    length disagrees with its prefix (33 compressed, 65 uncompressed)
    fails with ERR_INVALID_PUBLIC_KEY.  device: None (the GPU) or a torch
    device."""
    device = bt.resolve_device(device)
    n = pubs_sec1.shape[0]
    if pubs_sec1.shape[1] not in (33, 65) or digests.shape[0] != n \
            or digests.shape[1] < 32 or sigs.shape[0] != n:
        raise ValueError(
            f"expected pubs [n, 33|65], digests [n, >=32] and sigs [n, *]; "
            f"got {pubs_sec1.shape}, {digests.shape}, {sigs.shape}")
    if digests.shape[1] > 32:
        digests = np.ascontiguousarray(digests[:, :32])
    if lens is None:
        lens = np.full((n,), sigs.shape[1], dtype=np.int32)

    r_arr, s_arr, host_status = _e2e_host_parse(pubs_sec1, sigs, lens)
    if pub_lens is not None:
        expect = np.where(pubs_sec1[:, 0] == 0x04, 65, 33)
        host_status = np.where(
            (pub_lens != expect) & (host_status == ec.OK),
            ec.ERR_INVALID_PUBLIC_KEY, host_status).astype(np.int32)

    chunk_lanes = bt.auto_chunk(n, chunk_lanes)
    if chunk_lanes is None or n <= chunk_lanes:
        spans = [(0, n)]
    else:
        spans = [(lo, min(lo + chunk_lanes, n))
                 for lo in range(0, n, chunk_lanes)]
    outs = [_e2e_dispatch(pubs_sec1[lo:hi], digests[lo:hi], r_arr[lo:hi],
                          s_arr[lo:hi], host_status[lo:hi],
                          reject_malleable, device)
            for lo, hi in spans]
    return np.concatenate([o[:hi - lo].cpu().numpy()
                           for o, (lo, hi) in zip(outs, spans)])


def verify_raw_batch_status(pubs, digests, rs_pairs, device=None) -> list:
    """Verify (r, s) int pairs against public keys (objects with a
    `.point` (x, y), or (x, y) pairs) and digests.  Returns per-lane status
    codes (OK / ERR_INVALID_SIGNATURE / ERR_R_IS_INFINITY / ERR_V_NEQ_R)."""
    device = bt.resolve_device(device)
    n = len(pubs)
    pts = [p.point if hasattr(p, "point") else tuple(p) for p in pubs]
    b = bt.bucket(n)
    qx = bt.plane([p[0] for p in pts], b, fill=hc.GX, device=device)
    qy = bt.plane([p[1] for p in pts], b, fill=hc.GY, device=device)
    e_plane = bt.plane([hash_to_scalar_int(d) for d in digests], b,
                       device=device)
    r_plane = bt.plane([r for r, _ in rs_pairs], b, fill=1, device=device)
    s_plane = bt.plane([s for _, s in rs_pairs], b, fill=1, device=device)
    status = _verify_impl(qx, qy, e_plane, r_plane, s_plane)
    return [int(st) for st in bt.unplane_flags(status, n)]
