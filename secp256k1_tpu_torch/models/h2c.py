"""RFC 9380 hash-to-curve suites, batched.

The port of `secp256k1_tpu.models.h2c`: suites
`secp256k1_XMD:SHA-256_SSWU_RO_` and `_NU_` over `expand_message_xmd`
(SHA-256, with the oversize-DST reduction and the edge-case rejections on
the host), the SWU map and the point addition on the device.

Entry points take `device=None`, which means the GPU, and raise when there
is none; `device="cpu"` runs the plain path.  The random-oracle suite runs
its two maps as one map over both halves of the batch side by side (twice
the width, half the launches); every lane's value is the one of two maps.
The arrays entry points take messages of varying length as zero-padded rows
and their lengths; their cores expand on the device first
(`kernels.expand_xmd`, whose plain version is `expand_message_xmd_batch`).
The list entry points expand each message on the host.
`expand_message_xmd_batch` hashes with the native library and raises where
it does not build: there is no per-lane fallback.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import native
from ..ops import field as fe
from ..ops import point as pt
from ..ops import swu
from ..ops.cuda import kernels as K
from ..utils import batching as bt
from ..utils import profiling

_H_OUT = 32   # SHA-256 output
_H_BLOCK = 64  # SHA-256 block
_MAX_DST = 255
_OVERSIZE_PREFIX = b"H2C-OVERSIZE-DST-"


def _dst_and_ell(dst: bytes, n_out: int):
    """The DST as hashed (reduced when longer than 255 bytes) and the
    block count ell; raises on an empty DST, ell > 255 or n_out > 65535."""
    if len(dst) == 0:
        raise ValueError("empty DST")
    if len(dst) > _MAX_DST:
        dst = hashlib.sha256(_OVERSIZE_PREFIX + dst).digest()
    ell = (n_out + _H_OUT - 1) // _H_OUT
    if ell > 255 or n_out > 65535:
        raise ValueError("invalid expand_message_xmd length")
    return dst, ell


def expand_message_xmd(msg: bytes, dst: bytes, n_out: int) -> bytes:
    """RFC 9380 section 5.3.1 expand_message_xmd with SHA-256, one message
    on the host."""
    dst, ell = _dst_and_ell(dst, n_out)
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _H_BLOCK
    l_i_b_str = n_out.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = b1
    b_prev = b1
    for i in range(2, ell + 1):
        strxor = bytes(x ^ y for x, y in zip(b0, b_prev))
        b_prev = hashlib.sha256(strxor + bytes([i]) + dst_prime).digest()
        out += b_prev
    return out[:n_out]


# SHA-256 compressions that `expand_message_xmd_batch` ran on the host, as
# the native hashing counts them ("blocks"), and the messages it expanded
# ("messages").
XMD_HOST_BLOCKS = {"blocks": 0, "messages": 0}


def expand_message_xmd_batch(msgs: np.ndarray, dst: bytes, n_out: int,
                             lens=None) -> np.ndarray:
    """expand_message_xmd over msgs [n, L] u8: row i is the message of
    its first lens[i] bytes (lens [n] integers in [0, L]; None: every row
    whole).  One native call a hash stage (1 + ell calls), the first over
    the rows each at its own length, between Z_pad and b0's tail.  The
    same bytes as `expand_message_xmd`; counts its compressions in
    `XMD_HOST_BLOCKS`.  Raises if the native library does not build."""
    dst, ell = _dst_and_ell(dst, n_out)
    n = msgs.shape[0]
    dst_prime = dst + bytes([len(dst)])
    # b0 = H(Z_pad || msg || I2OSP(n_out, 2) || I2OSP(0, 1) || DST_prime)
    b0 = native.sha256_batch(
        msgs, lens, prefix=bytes(_H_BLOCK),
        suffix=n_out.to_bytes(2, "big") + b"\x00" + dst_prime,
        tally=XMD_HOST_BLOCKS)
    prev = native.sha256_batch(b0, suffix=b"\x01" + dst_prime,
                               tally=XMD_HOST_BLOCKS)
    blocks = [prev]
    for i in range(2, ell + 1):
        prev = native.sha256_batch(b0 ^ prev, suffix=bytes([i]) + dst_prime,
                                   tally=XMD_HOST_BLOCKS)
        blocks.append(prev)
    XMD_HOST_BLOCKS["messages"] += n
    return np.concatenate(blocks, axis=1)[:, :n_out]


def _ro_point(u):
    """Both maps as one over u [48, 2B] (u0's lanes, then u1's), then the
    complete add of the two halves."""
    b = u.shape[1] // 2
    q = swu.set_uniform_bytes(u)
    return pt.add(*(pt.Point(*(c[:, i * b:(i + 1) * b] for c in q))
                    for i in range(2)))


def _ro_core(u0_bytes, u1_bytes):
    """Two SWU maps and a complete add: affine (x, y) planes and the
    identity mask."""
    p = _ro_point(torch.cat([u0_bytes, u1_bytes], 1))
    aff = pt.to_affine(p)
    return aff.x, aff.y, pt.is_identity(p)


def _nu_core(u_bytes):
    q = swu.set_uniform_bytes(u_bytes)
    aff = pt.to_affine(q)
    return aff.x, aff.y, pt.is_identity(q)


def _from_planes(x, y, ident, n):
    xs = bt.unplane_ints(x, n)
    ys = bt.unplane_ints(y, n)
    idents = bt.unplane_flags(ident, n)
    return [None if i else (a, b) for a, b, i in zip(xs, ys, idents)]


def hash_to_curve_batch(msgs, dst: bytes, device=None):
    """secp256k1_XMD:SHA-256_SSWU_RO_ for a list of messages (bytes).
    Returns affine (x, y) int pairs (None for the identity)."""
    device = bt.resolve_device(device)
    n = len(msgs)
    b = bt.bucket(n)
    u0s, u1s = [], []
    for m in msgs:
        uniform = expand_message_xmd(m, dst, 96)
        u0s.append(uniform[:48])
        u1s.append(uniform[48:])
    x, y, ident = _ro_core(
        bt.byte_plane(u0s, b, fill=b"\x00" * 48, device=device),
        bt.byte_plane(u1s, b, fill=b"\x00" * 48, device=device))
    return _from_planes(x, y, ident, n)


def encode_to_curve_batch(msgs, dst: bytes, device=None):
    """secp256k1_XMD:SHA-256_SSWU_NU_ (non-uniform, one map)."""
    device = bt.resolve_device(device)
    n = len(msgs)
    b = bt.bucket(n)
    us = [expand_message_xmd(m, dst, 48) for m in msgs]
    x, y, ident = _nu_core(bt.byte_plane(us, b, fill=b"\x00" * 48,
                                         device=device))
    return _from_planes(x, y, ident, n)


def _affine_bytes(p):
    """Affine x and y as [32, B] big-endian byte planes, and the identity
    mask."""
    aff = pt.to_affine(p)
    return fe.to_bytes(aff.x), fe.to_bytes(aff.y), pt.is_identity(p)


def _ro_bytes_core(rows, lens, dst_prime: bytes, lanes: int):
    """The random-oracle suite's device work of an arrays call: the
    expansion of every message (rows [n, W] u8, lens [n] int32, DST') to
    the [48, 2 lanes] plane of u0 and u1, both maps, the add, the affine
    bytes."""
    return _affine_bytes(_ro_point(K.expand_xmd(rows, lens, dst_prime, 96,
                                                lanes)))


def _nu_bytes_core(rows, lens, dst_prime: bytes, lanes: int):
    """The non-uniform suite's: the expansion to [48, lanes], one map."""
    return _affine_bytes(swu.set_uniform_bytes(
        K.expand_xmd(rows, lens, dst_prime, 48, lanes)))


def _h2c_arrays(msgs: np.ndarray, dst: bytes, random_oracle: bool, lens,
                device):
    """The arrays entry points: the `h2c.call` root, its `h2c.planes` (the
    lengths' check, the DST, both uploads), `h2c.core` (`lanes`) and
    `h2c.readback` spans."""
    device = bt.resolve_device(device)
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    if msgs.ndim != 2 or not msgs.shape[0]:
        raise ValueError(f"expected [n >= 1, L] uint8 rows, got {msgs.shape}")
    n, width = msgs.shape
    with profiling.entry("h2c"):
        with profiling.span("h2c.planes"):
            lens = np.full(n, width, np.int32) if lens is None \
                else native.lane_lengths(lens, n, width)
            dst, _ = _dst_and_ell(dst, 96 if random_oracle else 48)
            rows_d = torch.from_numpy(msgs).to(device)
            lens_d = torch.from_numpy(lens).to(device)
        core = _ro_bytes_core if random_oracle else _nu_bytes_core
        with profiling.span("h2c.core", device.type == "cuda") as sp:
            sp.lanes = n
            xb, yb, ident = core(rows_d, lens_d, dst + bytes([len(dst)]),
                                 bt.bucket(n))
        with profiling.span("h2c.readback"):
            xs = xb[:, :n].cpu().numpy().astype(np.uint8).T
            ys = yb[:, :n].cpu().numpy().astype(np.uint8).T
            return np.concatenate([xs, ys], axis=1), ident[:n].cpu().numpy()


def hash_to_curve_batch_arrays(msgs: np.ndarray, dst: bytes, lens=None,
                               device=None):
    """secp256k1_XMD:SHA-256_SSWU_RO_ on numpy arrays.  msgs: [n, L] u8
    zero-padded rows, row i the message of its first lens[i] bytes (lens
    [n] integers in [0, L]; None: every row whole, of length L).  The
    host checks the lengths and uploads rows and lengths once; the
    expansion, both maps and the add run on the device.  Returns (points
    [n, 64] u8 affine x || y, is_identity [n] bool); raises ValueError on a
    bad lens or no rows."""
    return _h2c_arrays(msgs, dst, True, lens, device)


def encode_to_curve_batch_arrays(msgs: np.ndarray, dst: bytes, lens=None,
                                 device=None):
    """secp256k1_XMD:SHA-256_SSWU_NU_ on numpy arrays (one map); msgs and
    lens as in `hash_to_curve_batch_arrays`."""
    return _h2c_arrays(msgs, dst, False, lens, device)


def hash_to_curve(msg: bytes, dst: bytes, device=None):
    return hash_to_curve_batch([msg], dst, device=device)[0]


def encode_to_curve(msg: bytes, dst: bytes, device=None):
    return encode_to_curve_batch([msg], dst, device=device)[0]
