"""Batched ECDSA (SEC 1 4.1.3 sign, 4.1.4 verify, 4.1.6 recover) on PyTorch.

The port of `secp256k1_tpu.models.ecdsa`.  The host parses signatures with
the native library (`secp256k1_tpu_torch.native`); decompression,
hash-to-scalar reduction, batch inversion and the group math run on the
device, through the CUDA kernels of `ops/cuda` when the device is a GPU.
RFC 6979 nonces are derived on the device too (the `rfc6979_nonce`
kernel, the sign core's first launch), for `sign_batch_arrays` and for
`sign_batch` under `RFC6979SHA256`, which signs through it.  Signing
computes k*G with the constant-time fixed-base kernel (the nonce is
secret); verify and recover use the GLV and public-digit fixed-base
kernels.  On the GPU the sign core's first candidate runs as one CUDA
graph a width, captured at its first call (`_sign_e2e_core`), and so does
the verify stage from byte planes (`_verify_stage`).

Entry points take `device=None`, which means the GPU, and raise when there
is none; the CPU runs only when the caller passes `device="cpu"`.  A keyed
`PubkeyCache` lives on the device it was built for.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import native
from ..ops import field as fe
from ..ops import glv
from ..ops import limbs as lb
from ..ops import point as pt
from ..ops import s11n
from ..ops import scalar as sc
from ..ops import table as tbl
from ..ops.cuda import kernels as K
from ..utils import batching as bt
from ..utils import config as cfg
from ..utils import errors as ec
from ..utils import graphs
from ..utils import hostcurve as hc
from ..utils import profiling
from . import codecs
from . import keys as keysmod
from .rfc6979 import DrbgRFC6979, RFC6979SHA256  # noqa: F401
from .tuplehash import TupleHashXOF128

N = hc.N
_N_LIMBS = lb.int_to_limbs(N)
_P17_LIMBS = lb.int_to_limbs(hc.P, 17)
DOMAIN_SEP_ECDSA = "ECDSA-Sign"
MAX_SCALAR_RESAMPLES = 8


def _status_where(cond, code, other):
    """`code` where cond, else other (an int32 plane); the code is a
    scalar of the launch, not a tensor copied from the host."""
    return torch.where(cond, code, other)


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


# The name the sharded verify and the verify stage's graph call (the JAX
# package's jit of _verify_impl; eager PyTorch has nothing to compile).
_verify_core = _verify_impl


def _finish(st, pub_status, s, reject_malleable, host_status):
    if pub_status is not None:
        st = _status_where(pub_status != ec.OK, ec.ERR_INVALID_PUBLIC_KEY,
                           st)
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
    `host_status` (parse failures) takes precedence.  Runs as
    `_verify_stage` does."""
    return _verify_stage((want_odd, None, pub_x_bytes, None, e_bytes,
                          r_bytes, s_bytes, host_status), reject_malleable)


def _verify_e2e_mixed_core(want_odd, is_unc, x_bytes, y_bytes, e_bytes,
                           r_bytes, s_bytes, reject_malleable=False,
                           host_status=None):
    """`_verify_e2e_core` with per-lane SEC1 encodings: lanes with is_unc
    take the uncompressed decode, others decompress from x.  Both decodes
    run on every lane (uniform schedule); the result is a per-lane
    select."""
    return _verify_stage((want_odd, is_unc, x_bytes, y_bytes, e_bytes,
                          r_bytes, s_bytes, host_status), reject_malleable)


def _verify_stage(planes, reject_malleable):
    """The device stage over `planes` (want_odd, is_unc or None, x, y or
    None, e, r and s bytes, host status or None) inside the `verify.core`
    span, which covers the whole stage however it runs (its `lanes` the
    width; on a card `how`: captured, replayed or eager): through a CUDA
    graph (`graphs.Cache.run`) where `_verify_graph_key` gives the planes
    one, else eagerly, the core called as `_verify_impl`.  Returns the
    status plane."""
    on_card = planes[2].is_cuda
    key = _verify_graph_key(planes, reject_malleable)
    with profiling.span("verify.core", on_card) as sp:
        sp.lanes = planes[2].shape[-1]
        if key is not None:
            out, sp.how = _ECDSA_VERIFY_CACHE.run(
                key, functools.partial(_verify_stage_body, _verify_core,
                                       reject_malleable), planes)
            return out[0]
        if on_card:
            ECDSA_VERIFY_GRAPHS["eager"] += 1
            sp.how = "eager"
        return _verify_stage_body(_verify_impl, reject_malleable, *planes)[0]


# How the ECDSA verify stage's calls on the GPU ran (`graphs.Cache.counts`).
_ECDSA_VERIFY_CACHE = graphs.Cache()
ECDSA_VERIFY_GRAPHS = _ECDSA_VERIFY_CACHE.counts
# The widest stage that gets a graph.  Each key keeps its graph's memory
# pool for the life of the process: on an H100, 0.71 GB at 65,536 lanes
# and 1.83 GB at 131,072, where the graph's call takes 0.43 and 0.75 of the
# eager stage's; at 2^18 lanes 2.55 GB for 0.90, at 2^20 10.2 GB for 0.99,
# so a wider stage runs eagerly.
VERIFY_GRAPH_MAX_LANES = 1 << 17


def _verify_graph_key(planes, reject_malleable):
    """The key of the CUDA graph that verifies these planes, or None where
    the stage runs eagerly: planes off the GPU, byte planes that are not
    all contiguous uint8 [32, B] on one device (`graphs.plane_width`),
    flags and statuses that are not contiguous bool and int32 [B] there
    (`graphs.lanes_fit`), or B above `VERIFY_GRAPH_MAX_LANES`.  The key
    holds what the stage's launches depend on: the device, the width B,
    the mixed 33/65-byte layout, `reject_malleable`, whether there is a
    host status plane, and the GLV and fixed-base switches in force."""
    want_odd, is_unc, x_bytes, y_bytes, e_bytes, r_bytes, s_bytes, host = \
        planes
    width = graphs.plane_width((x_bytes, y_bytes, e_bytes, r_bytes, s_bytes))
    if width is None or width > VERIFY_GRAPH_MAX_LANES:
        return None
    device = x_bytes.device
    if not (graphs.lanes_fit((want_odd, is_unc), width, device, torch.bool)
            and graphs.lanes_fit((host,), width, device, torch.int32)):
        return None
    return (device, width, is_unc is not None, bool(reject_malleable),
            host is not None, *graphs.switches())


def _verify_stage_body(core, reject_malleable, want_odd, is_unc, x_bytes,
                       y_bytes, e_bytes, r_bytes, s_bytes, host_status):
    """The device stage as a 1-tuple: decompress (where is_unc is a plane,
    the uncompressed decode too and a per-lane select), `_scalars`,
    `core`, `_finish`.  The eager stage passes `_verify_impl`, as the
    module holds it when called; a graph captures `_verify_core`, so a
    wrapper installed over `_verify_impl` (a profiling harness's CUDA
    events) is never captured."""
    with profiling.span("verify.decompress", x_bytes.is_cuda):
        pub, pub_status = s11n.decompress(want_odd, x_bytes)
        if is_unc is not None:
            pub_u, st_u = s11n.decode_uncompressed(x_bytes, y_bytes)
            pub = pt.select(is_unc, pub_u, pub)
            pub_status = torch.where(is_unc, st_u, pub_status)
    e, r, s = _scalars(e_bytes, r_bytes, s_bytes)
    st = core(pub.x, pub.y, e, r, s)
    return (_finish(st, pub_status, s, reject_malleable, host_status),)


def _verify_keyed_core(qx_tab, qy_tab, idx, e_bytes, r_bytes, s_bytes,
                       reject_malleable=False, host_status=None):
    """Keyed verify: the public keys come from device-resident affine
    planes (qx_tab, qy_tab [16, K]) indexed per lane by idx [B] (public
    indices, validated by the host)."""
    idx = idx.long()
    qx = qx_tab[:, idx].contiguous()
    qy = qy_tab[:, idx].contiguous()
    e, r, s = _scalars(e_bytes, r_bytes, s_bytes)
    st = _verify_impl(qx, qy, e, r, s)
    return _finish(st, None, s, reject_malleable, host_status)


def _sign_core(k, e, d):
    """SEC1 4.1.3 steps 1-6 and low-s for a batch of canonical nonce, digest
    and key planes.  Returns (r, s, recovery id, need_retry): recovery bit
    0 is the y parity, bit 1 "x >= n", XORed with the low-s negation;
    need_retry flags r = 0 or s = 0."""
    aff = pt.to_affine(tbl.scalar_base_mult(k))
    did_reduce = lb.geq_const(aff.x, sc.S.m_limbs)
    r = lb.mod_fold(aff.x, sc.S.c_limbs).to(lb.DTYPE)
    y_odd = fe.is_odd(aff.y)
    k_inv = sc.invert_auto(k)
    s = sc.mul(sc.add(e, sc.mul(r, d)), k_inv)
    retry = sc.is_zero(r) | sc.is_zero(s)
    neg = sc.is_greater_than_half_n(s)
    s = sc.cneg(neg, s)
    recid = ((did_reduce.to(torch.int32) << 1) | y_odd.to(torch.int32)) \
        ^ neg.to(torch.int32)
    return r, s, recid, retry


def _sign_e2e_core(d_bytes, e_bytes, extra_bytes, attempt: int):
    """Sign from byte planes: `_sign_e2e_body`, through a CUDA graph
    (`graphs.Cache.run`) where `_sign_graph_key` gives the planes one;
    other planes (the CPU, a resample pass) run the body eagerly.  Returns
    (r bytes, s bytes, recovery id, resample, bad_key) planes."""
    key = _sign_graph_key(d_bytes, e_bytes, extra_bytes, attempt)
    if key is None:
        if d_bytes.device.type == "cuda":
            SIGN_GRAPHS["eager"] += 1
            profiling.current().how = "eager"
        return _sign_e2e_body(d_bytes, e_bytes, extra_bytes, attempt)
    out, how = _SIGN_CACHE.run(key, _sign_first_candidate,
                               (d_bytes, e_bytes, extra_bytes))
    profiling.current().how = how
    return out


def _sign_e2e_body(d_bytes, e_bytes, extra_bytes, attempt: int):
    """Sign from byte planes: each lane's nonce candidate `attempt` of its
    RFC 6979 DRBG seeded with key || e || extra (`K.rfc6979_nonce`; e the
    digest reduced mod n, extra_bytes None or RFC 6979 3.6 additional
    data), then `_sign_from_candidates`.  Returns (r bytes, s bytes,
    recovery id, resample, bad_key) planes."""
    k_bytes = K.rfc6979_nonce(d_bytes, e_bytes, extra_bytes, attempt)
    return _sign_from_candidates(k_bytes, e_bytes, d_bytes)


def _sign_first_candidate(d_bytes, e_bytes, extra_bytes):
    return _sign_e2e_body(d_bytes, e_bytes, extra_bytes, 0)


# How the sign core's rounds on the GPU ran (`graphs.Cache.counts`).
_SIGN_CACHE = graphs.Cache()
SIGN_GRAPHS = _SIGN_CACHE.counts
_SIGN_GRAPH_OF = _SIGN_CACHE.graphs  # `_sign_graph_key` -> `graphs.Captured`


def _sign_graph_key(d_bytes, e_bytes, extra_bytes, attempt: int):
    """The key of the CUDA graph that signs these planes, or None where
    the body runs eagerly: planes off the GPU, a resample pass (attempt >
    0), or planes that are not all contiguous uint8 [32, B] on one device
    (`graphs.plane_width`).  The key holds what the body's launches depend
    on: the device, the width B, whether there is extra data, and the
    fixed-base switches in force (`table.base_signed_enabled`,
    `table.base_window`)."""
    if attempt != 0:
        return None
    width = graphs.plane_width((d_bytes, e_bytes, extra_bytes))
    if width is None:
        return None
    return (d_bytes.device, width, extra_bytes is not None,
            *graphs.switches(glv=False))


def _sign_from_candidates(k_bytes, e_bytes, d_bytes):
    """Sign from byte planes: candidate and key validity, then SEC1 4.1.3
    and low-s (the JAX package's `_sign_e2e_core`).  k_bytes are raw DRBG
    candidates; a lane whose candidate is not in [1, n), or whose r or s
    is 0, is flagged for a resample.  Bad candidates and keys run with 1
    in their place.  Returns (r bytes, s bytes, recovery id, resample,
    bad_key) planes."""
    k = sc.S._bytes_to_limbs(k_bytes)
    k_bad = lb.geq_const(k, sc.S.m_limbs) | lb.is_zero(k)
    d = sc.S._bytes_to_limbs(d_bytes)
    bad_key = lb.geq_const(d, sc.S.m_limbs) | lb.is_zero(d)
    e, _ = sc.S.from_bytes_any(e_bytes)
    one = sc.S.one(k.shape[1:], k.device)
    k_safe = lb.select(~k_bad, k, one).to(lb.DTYPE)
    d_safe = lb.select(~bad_key, d, one).to(lb.DTYPE)
    r, s, recid, retry = _sign_core(k_safe, e, d_safe)
    return (sc.S.to_bytes(r), sc.S.to_bytes(s), recid, k_bad | retry,
            bad_key)


def _recover_core(r_bytes, recid, e, r, s):
    """SEC1 4.1.6 with an explicit recovery id: Q = (-e/r) G + (s/r) R.
    Returns (x bytes, y bytes, status) planes."""
    big_r, rec_status = s11n.recover_point(r_bytes, recid)
    r_inv = sc.invert_auto(r)
    u1 = sc.mul(sc.neg(e), r_inv)
    u2 = sc.mul(s, r_inv)
    q = glv.double_scalar_mult_basepoint(u1, u2, big_r)
    xb, yb, _, is_inf = s11n.affine_bytes(q)
    bad_rs = sc.is_zero(r) | sc.is_zero(s)
    st = torch.full(bad_rs.shape, ec.OK, dtype=torch.int32,
                    device=bad_rs.device)
    st = _status_where(is_inf, ec.ERR_INVALID_PUBLIC_KEY, st)
    st = torch.where(rec_status != ec.OK, rec_status.to(torch.int32), st)
    return xb, yb, _status_where(bad_rs, ec.ERR_INVALID_SIGNATURE, st)


# ---------------------------------------------------------------------------
# Host helpers.
# ---------------------------------------------------------------------------

def hash_to_scalar_int(digest: bytes) -> int:
    """Leftmost 256 bits of the digest, reduced mod n."""
    if len(digest) < 32:
        raise ValueError("invalid digest")
    return int.from_bytes(digest[:32], "big") % N


def _parse_sigs_host(sigs: np.ndarray, lens: np.ndarray, n: int,
                     parse=native.asn1_sig_parse_batch):
    """Parse every row in one native call, `parse` (strict DER by
    default): (r_arr [n, 32] u8, s_arr [n, 32] u8, host_status [n] int32),
    no key checks and no inert fill."""
    r_arr, s_arr, pstat = parse(sigs[:n], lens[:n])
    host_status = np.where(
        pstat == 0, ec.OK,
        np.where(pstat == 1, ec.ERR_INVALID_ENCODING,
                 ec.ERR_INVALID_SCALAR)).astype(np.int32)
    return r_arr, s_arr, host_status


def _reduce_digest_np(digests: np.ndarray) -> np.ndarray:
    """[n, 32] u8 big-endian digests -> e = int(digest) mod n as [n, 32] u8:
    one conditional subtract (2^256 < 2n), by a lexicographic compare and a
    byte borrow chain, with no per-lane Python ints."""
    nrow = np.frombuffer(N.to_bytes(32, "big"), np.uint8).astype(np.int16)
    d = digests.astype(np.int16)
    diff = d - nrow[None]
    nz = diff != 0
    first = np.argmax(nz, axis=1)
    ge = np.where(nz.any(axis=1),
                  np.take_along_axis(diff, first[:, None], 1)[:, 0] > 0, True)
    res = d.copy()
    res[ge] -= nrow[None]
    for j in range(31, 0, -1):
        borrow = (res[:, j] < 0).astype(np.int16)
        res[:, j] += 256 * borrow
        res[:, j - 1] -= borrow
    return res.astype(np.uint8)


def _nonce_reader(rand, priv: keysmod.PrivateKey, e: int):
    """The entropy nonce reader: TupleHashXOF128 over (key, 32 bytes of
    entropy, e) with the ECDSA domain separator, which stays safe when the
    entropy source is broken (all zeros, repeated)."""
    read = os.urandom if rand is None else rand.read
    entropy = read(32)
    if len(entropy) != 32:
        raise ValueError("entropy source failure")
    xof = TupleHashXOF128(
        b"Honorary Debian/Sony RNG mitigation:" + DOMAIN_SEP_ECDSA.encode())
    xof.write(priv.bytes())
    xof.write(entropy)
    xof.write(e.to_bytes(32, "big"))
    return xof.read


def _check_digest(digest: bytes, opts: cfg.ECDSAOptions):
    want = cfg.HASH_SIZES.get(opts.hash)
    if want is not None and len(digest) != want:
        raise ValueError("invalid digest length")


def _encode_sig(r, s, v, encoding):
    if encoding == cfg.SignatureEncoding.ASN1:
        return codecs.build_asn1_signature(r, s)
    if encoding == cfg.SignatureEncoding.COMPACT:
        return codecs.build_compact_signature(r, s)
    if encoding == cfg.SignatureEncoding.COMPACT_RECOVERABLE:
        return codecs.build_compact_recoverable_signature(r, s, v)
    raise ValueError("invalid encoding")


def _rows_of_ints(vals) -> np.ndarray:
    """Python ints < 2^256 -> [n, 32] u8 big-endian rows."""
    return np.frombuffer(b"".join(int(v).to_bytes(32, "big") for v in vals),
                         np.uint8).reshape(-1, 32)


def _plane_rows(plane: torch.Tensor, n: int) -> np.ndarray:
    """[32, B] byte plane -> [n, 32] u8 rows."""
    return plane[:, :n].T.cpu().numpy().astype(np.uint8)


def _inert_fill(r_arr, s_arr, host_status):
    """Failed lanes get inert device inputs (r = s = 1), written in place
    into the parse's own rows: only the failed rows are touched, where a
    masked copy would rewrite both [n, 32] arrays."""
    one32 = np.zeros((32,), np.uint8)
    one32[31] = 1
    bad = np.flatnonzero(host_status != ec.OK)
    r_arr[bad] = one32
    s_arr[bad] = one32
    return r_arr, s_arr


def _e2e_host_parse(pubs_sec1: np.ndarray, sigs: np.ndarray,
                    lens: np.ndarray, parse=native.asn1_sig_parse_batch):
    """Host stage: the signature parse (`_parse_sigs_host`) and key prefix
    checks.  In a 65-byte wide batch a compressed key's 32 pad bytes must
    be zero (the JAX package ignores them); a lane that breaks that fails
    with ERR_INVALID_PUBLIC_KEY."""
    n = pubs_sec1.shape[0]
    r_arr, s_arr, host_status = _parse_sigs_host(sigs, lens, n, parse)
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
    """Marshal one chunk to planes on `device` (the `verify.planes` span)
    and run the device stage (asynchronous on a GPU: returns the status
    tensor)."""
    n = pubs_sec1.shape[0]
    b = bt.bucket(n)
    mixed = pubs_sec1.shape[1] == 65
    with profiling.span("verify.planes"):
        prefix = pubs_sec1[:, 0]
        want_odd = bt.scalar_plane(prefix == 0x03, b, fill=False,
                                   dtype=torch.bool, device=device)
        host = bt.scalar_plane(host_status, b, device=device)
        if mixed:
            is_unc = bt.scalar_plane(prefix == 0x04, b, fill=False,
                                     dtype=torch.bool, device=device)
            keys = [bt.byte_plane_np(pubs_sec1[:, 1:33], b, device),
                    bt.byte_plane_np(pubs_sec1[:, 33:65], b, device)]
        else:
            keys = [bt.byte_plane_np(pubs_sec1[:, 1:], b, device)]
        rows = [bt.byte_plane_np(a, b, device) for a in (digests, r_arr,
                                                          s_arr)]
    if mixed:
        return _verify_e2e_mixed_core(want_odd, is_unc, *keys, *rows,
                                      reject_malleable, host)
    return _verify_e2e_core(want_odd, *keys, *rows, reject_malleable, host)


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
    return _verify_arrays(pubs_sec1, digests, sigs, lens, reject_malleable,
                          chunk_lanes, pub_lens, bt.resolve_device(device))


def _verify_arrays(pubs_sec1, digests, sigs, lens, reject_malleable,
                   chunk_lanes, pub_lens, device,
                   parse=native.asn1_sig_parse_batch):
    """`verify_batch_arrays` on a resolved device, the rows read by the
    native parser `parse` (arguments and statuses of
    `native.asn1_sig_parse_batch`): the `verify.call` root with its
    `verify.parse`, `verify.planes`, `verify.core` (the device stage,
    `verify.decompress` inside it where the stage runs eagerly) and
    `verify.readback` spans."""
    n = pubs_sec1.shape[0]
    if pubs_sec1.shape[1] not in (33, 65) or digests.shape[0] != n \
            or digests.shape[1] < 32 or sigs.shape[0] != n:
        raise ValueError(
            f"expected pubs [n, 33|65], digests [n, >=32] and sigs [n, *]; "
            f"got {pubs_sec1.shape}, {digests.shape}, {sigs.shape}")
    with profiling.entry("verify"):
        if digests.shape[1] > 32:
            digests = np.ascontiguousarray(digests[:, :32])
        if lens is None:
            lens = np.full((n,), sigs.shape[1], dtype=np.int32)

        with profiling.span("verify.parse"):
            r_arr, s_arr, host_status = _e2e_host_parse(pubs_sec1, sigs,
                                                        lens, parse)
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
        outs = [_e2e_dispatch(pubs_sec1[lo:hi], digests[lo:hi],
                              r_arr[lo:hi], s_arr[lo:hi], host_status[lo:hi],
                              reject_malleable, device)
                for lo, hi in spans]
        with profiling.span("verify.readback"):
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


def verify_raw_batch(pubs, digests, rs_pairs, device=None) -> list:
    """Verify (r, s) int pairs against pubs and digests.  Returns [bool]."""
    return [st == ec.OK for st in verify_raw_batch_status(
        pubs, digests, rs_pairs, device=device)]


def verify_batch_status(pubs, digests, sigs,
                        opts: cfg.ECDSAOptions | None = None,
                        device=None) -> list:
    """Parse encoded signatures and verify them against `keys.PublicKey`s;
    returns per-lane status codes: ERR_INVALID_DIGEST (digest length),
    ERR_INVALID_ENCODING (malformed DER or compact), ERR_INVALID_SCALAR
    (r or s out of range), ERR_MALLEABLE (s > n/2 under reject_malleable),
    then the device statuses.  Recoverable signatures are checked by
    recovering the key and comparing (ERR_VERIFY_FAILED on a mismatch)."""
    opts = opts or cfg.ECDSAOptions()
    parsed, lane_status = [], []
    digests = list(digests)
    for i, sig in enumerate(sigs):
        status = ec.OK
        r, s, v = 1, 1, 0
        try:
            _check_digest(digests[i], opts)
            if len(digests[i]) < 32:
                raise ValueError("invalid digest")
        except ValueError:
            status = ec.ERR_INVALID_DIGEST
        if status == ec.OK:
            try:
                if opts.encoding == cfg.SignatureEncoding.ASN1:
                    r, s = codecs.parse_asn1_signature(sig)
                elif opts.encoding == cfg.SignatureEncoding.COMPACT:
                    r, s = codecs.parse_compact_signature(sig)
                elif opts.encoding == \
                        cfg.SignatureEncoding.COMPACT_RECOVERABLE:
                    r, s, v = codecs.parse_compact_recoverable_signature(sig)
                else:
                    raise codecs.CodecError("invalid encoding")
                if opts.reject_malleable and s > N // 2:
                    status = ec.ERR_MALLEABLE
            except codecs.ScalarError:
                status = ec.ERR_INVALID_SCALAR
            except (codecs.CodecError, ValueError):
                status = ec.ERR_INVALID_ENCODING
        if status != ec.OK:
            r, s, v = 1, 1, 0
            digests[i] = bytes(32)          # keeps the device batch valid
        parsed.append((r, s, v))
        lane_status.append(status)

    if opts.encoding == cfg.SignatureEncoding.COMPACT_RECOVERABLE:
        recs = recover_batch(digests, parsed, device=device)
        return [st if st != ec.OK else
                (ec.OK if rec is not None and rec == pub
                 else ec.ERR_VERIFY_FAILED)
                for st, rec, pub in zip(lane_status, recs, pubs)]
    dev = verify_raw_batch_status(pubs, digests, [(r, s) for r, s, _ in
                                                  parsed], device=device)
    return [st if st != ec.OK else d for st, d in zip(lane_status, dev)]


def verify_batch(pubs, digests, sigs, opts: cfg.ECDSAOptions | None = None,
                 device=None) -> list:
    """Boolean form of `verify_batch_status`: True where the status is OK."""
    return [st == ec.OK for st in verify_batch_status(
        pubs, digests, sigs, opts=opts, device=device)]


def _sign_arrays_device(d_arr, digests, extra, attempt, device):
    """One `_sign_e2e_core` call on [n, 32] u8 key, digest and extra (or
    None) rows at candidate `attempt`, as the `sign.planes` (the digests
    reduced mod n, three byte planes), `sign.core` and `sign.readback`
    spans: (sigs [n, 64] r || s, recids [n], resample [n], bad_key [n])."""
    n = d_arr.shape[0]
    b = bt.bucket(n)
    with profiling.span("sign.planes"):
        planes = [None if a is None else bt.byte_plane_np(a, b, device)
                  for a in (d_arr, _reduce_digest_np(digests), extra)]
    with profiling.span("sign.core", device.type == "cuda") as sp:
        sp.lanes = n
        r_b, s_b, recid, resample, bad = _sign_e2e_core(*planes, attempt)
    with profiling.span("sign.readback"):
        sigs = np.concatenate([_plane_rows(r_b, n), _plane_rows(s_b, n)], 1)
        return (sigs, recid[:n].cpu().numpy().astype(np.int32),
                resample[:n].cpu().numpy(), bad[:n].cpu().numpy())


def sign_batch_arrays(priv_bytes: np.ndarray, digests: np.ndarray,
                      device=None, extra: np.ndarray | None = None):
    """Deterministic (RFC 6979, SHA-256) batched sign on numpy arrays.

    priv_bytes: [n, 32] u8 big-endian private scalars; digests: [n, 32] u8;
    extra: None, or [n, 32] u8 rows of RFC 6979 3.6 additional data that
    each lane's DRBG seed takes after the reduced digest (libsecp256k1's
    `ndata`).
    The host reduces the digests mod n and uploads the rows; the device
    derives every lane's nonce candidate (`_sign_e2e_core`: one
    `rfc6979_nonce` launch, then one k*G launch and the scalar math).
    Lanes flagged for a resample (candidate not in [1, n), r = 0 or s = 0;
    each about 2^-128) run again at the next candidate of their DRBG, pass
    c taking candidate c, until none is left.
    Returns (sigs [n, 64] u8 r || s, recids [n] int32, status [n] int32);
    a lane whose key is not in [1, n) gets ERR_INVALID_SCALAR and zeros."""
    device = bt.resolve_device(device)
    n = priv_bytes.shape[0]
    if priv_bytes.shape != (n, 32) or digests.shape != (n, 32):
        raise ValueError(f"expected [n, 32] keys and digests, got "
                         f"{priv_bytes.shape} and {digests.shape}")
    if extra is not None:
        if extra.shape != (n, 32):
            raise ValueError(f"expected [{n}, 32] extra rows, got "
                             f"{extra.shape}")
        extra = np.ascontiguousarray(extra, dtype=np.uint8)
    with profiling.entry("sign"):
        priv_bytes = np.ascontiguousarray(priv_bytes, dtype=np.uint8)
        sigs, recid, resample, bad = _sign_arrays_device(
            priv_bytes, digests, extra, 0, device)
        todo = np.nonzero(resample & ~bad)[0]
        for attempt in range(1, MAX_SCALAR_RESAMPLES + 1):
            if not todo.size:
                break
            s2, v2, again, _ = _sign_arrays_device(
                priv_bytes[todo], digests[todo],
                None if extra is None else extra[todo], attempt, device)
            sigs[todo] = s2
            recid[todo] = v2
            todo = todo[again]
        if todo.size:
            raise RuntimeError("failed rejection sampling for r/s")
        status = np.where(bad, ec.ERR_INVALID_SCALAR, ec.OK).astype(np.int32)
        sigs[bad] = 0
        recid[bad] = 0
        return sigs, recid, status


def sign_batch(privs, digests, rand=None,
               opts: cfg.ECDSAOptions | None = None, device=None) -> list:
    """Sign a batch with one k*G launch for all lanes; returns encoded
    signatures.  privs: [keys.PrivateKey]; digests: [bytes]; rand: None
    (os.urandom entropy), an object with .read(n), or `RFC6979SHA256()` for
    deterministic signatures, which `sign_batch_arrays` makes (its nonces
    from the DRBG kernel, the same bytes as RFC 6979's per-lane reads)."""
    device = bt.resolve_device(device)
    opts = opts or cfg.ECDSAOptions()
    if len(digests) != len(privs):
        raise ValueError("privs and digests differ in length")
    for d in digests:
        _check_digest(d, opts)
    e_ints = [hash_to_scalar_int(d) for d in digests]
    if isinstance(rand, RFC6979SHA256):
        sigs, recid, _ = sign_batch_arrays(
            _rows_of_ints([p.scalar for p in privs]), _rows_of_ints(e_ints),
            device=device)
        results = [(int.from_bytes(row[:32].tobytes(), "big"),
                    int.from_bytes(row[32:].tobytes(), "big"), int(v))
                   for row, v in zip(sigs, recid)]
    else:
        results = _sign_with_readers(rand, privs, e_ints, device)
    if opts.self_verify:
        ok = verify_raw_batch([p.public_key for p in privs], digests,
                              [(r, s) for r, s, _ in results], device=device)
        if not all(ok):
            raise RuntimeError("failed to verify new sig")
    return [_encode_sig(r, s, v, opts.encoding) for r, s, v in results]


def _sign_with_readers(rand, privs, e_ints, device):
    """(r, s, v) a lane, each lane's nonces read from `_nonce_reader`, the
    lanes whose r or s is 0 signing again at their next read."""
    n = len(privs)
    readers = [_nonce_reader(rand, p, e) for p, e in zip(privs, e_ints)]
    ks = [keysmod.sample_random_scalar(rd) for rd in readers]
    b = bt.bucket(n)
    d_plane = bt.plane([p.scalar for p in privs], b, fill=1, device=device)
    e_plane = bt.plane(e_ints, b, device=device)
    results = [None] * n
    remaining = set(range(n))
    for _ in range(MAX_SCALAR_RESAMPLES):
        r, s, recid, retry = _sign_core(
            bt.plane(ks, b, fill=1, device=device), e_plane, d_plane)
        r_i, s_i = bt.unplane_ints(r, n), bt.unplane_ints(s, n)
        v_i, retry_i = bt.unplane_flags(recid, n), bt.unplane_flags(retry, n)
        for i in sorted(remaining):
            if retry_i[i]:
                ks[i] = keysmod.sample_random_scalar(readers[i])
            else:
                results[i] = (r_i[i], s_i[i], int(v_i[i]))
                remaining.discard(i)
        if not remaining:
            break
    if remaining:
        raise RuntimeError("failed rejection sampling for r/s")
    return results


class PubkeyCache:
    """Device-resident affine public keys for `verify_batch_arrays_keyed`:
    upload the distinct signers once, then verify batches that name their
    key by index.

    Every key is validated on the host: a `keys.PublicKey`, or an (x, y)
    pair of canonical coordinates on the curve.  Anything else raises
    (the JAX package's cache takes (x, y) pairs unchecked)."""

    def __init__(self, pubs, device=None):
        pts = [p.point if hasattr(p, "point") else p for p in pubs]
        if not pts:
            raise ValueError("empty key set")
        for i, p in enumerate(pts):
            if p is None or len(p) != 2 or not all(
                    0 <= int(c) < hc.P for c in p) \
                    or not hc.on_curve((int(p[0]), int(p[1]))):
                raise keysmod.KeyError_(
                    f"key {i} is not a point of the curve")
        self.device = bt.resolve_device(device)
        self.n_keys = len(pts)
        self.qx = torch.as_tensor(lb.int_to_limbs_batch(
            [int(x) for x, _ in pts]), dtype=lb.DTYPE, device=self.device)
        self.qy = torch.as_tensor(lb.int_to_limbs_batch(
            [int(y) for _, y in pts]), dtype=lb.DTYPE, device=self.device)

    @classmethod
    def from_sec1_arrays(cls, pubs_sec1: np.ndarray, device=None):
        """[K, 33|65] u8 SEC1 rows -> cache (host decode and validation)."""
        out = []
        for row in pubs_sec1:
            blen = 65 if row[0] == 0x04 else 33
            out.append(keysmod.PublicKey.from_bytes(row[:blen].tobytes()))
        return cls(out, device=device)


def verify_batch_arrays_keyed(cache: PubkeyCache, key_idx: np.ndarray,
                              digests: np.ndarray, sigs: np.ndarray,
                              lens: np.ndarray | None = None,
                              reject_malleable: bool = False,
                              chunk_lanes: int | None = None) -> np.ndarray:
    """`verify_batch_arrays` with keys named by index into `cache` (key_idx
    [n] int); runs on the cache's device.  An index out of range fails
    with ERR_INVALID_PUBLIC_KEY.  Same status contract as the unkeyed
    path."""
    n = key_idx.shape[0]
    if digests.shape[0] != n or digests.shape[1] < 32 or sigs.shape[0] != n:
        raise ValueError(f"expected digests [{n}, >=32] and sigs [{n}, *]; "
                         f"got {digests.shape}, {sigs.shape}")
    if digests.shape[1] > 32:
        digests = np.ascontiguousarray(digests[:, :32])
    if lens is None:
        lens = np.full((n,), sigs.shape[1], dtype=np.int32)
    r_arr, s_arr, host_status = _parse_sigs_host(sigs, lens, n)
    bad_idx = (key_idx < 0) | (key_idx >= cache.n_keys)
    host_status = np.where(bad_idx & (host_status == ec.OK),
                           ec.ERR_INVALID_PUBLIC_KEY,
                           host_status).astype(np.int32)
    r_arr, s_arr = _inert_fill(r_arr, s_arr, host_status)
    safe_idx = np.where(bad_idx, 0, key_idx).astype(np.int64)
    device = cache.device

    def dispatch(lo, hi):
        b = bt.bucket(hi - lo)
        return _verify_keyed_core(
            cache.qx, cache.qy,
            bt.scalar_plane(safe_idx[lo:hi], b, dtype=torch.int64,
                            device=device),
            bt.byte_plane_np(digests[lo:hi], b, device),
            bt.byte_plane_np(r_arr[lo:hi], b, device),
            bt.byte_plane_np(s_arr[lo:hi], b, device), reject_malleable,
            bt.scalar_plane(host_status[lo:hi], b, device=device))

    chunk_lanes = bt.auto_chunk(n, chunk_lanes)
    if chunk_lanes is None or n <= chunk_lanes:
        spans = [(0, n)]
    else:
        spans = [(lo, min(lo + chunk_lanes, n))
                 for lo in range(0, n, chunk_lanes)]
    outs = [dispatch(lo, hi) for lo, hi in spans]
    return np.concatenate([o[:hi - lo].cpu().numpy()
                           for o, (lo, hi) in zip(outs, spans)])


def recover_batch(digests, rsv_triples, device=None) -> list:
    """Recover public keys from (r, s, v) triples: [keys.PublicKey | None]
    per lane, None where recovery fails."""
    device = bt.resolve_device(device)
    n = len(rsv_triples)
    b = bt.bucket(n)
    if any(len(d) < 32 for d in digests):
        raise ValueError("invalid digest")
    dig = np.stack([np.frombuffer(d[:32], np.uint8) for d in digests])
    r_rows = _rows_of_ints([r for r, _, _ in rsv_triples])
    r_bytes = bt.byte_plane_np(r_rows, b, device)
    recid = bt.scalar_plane(np.asarray([v for _, _, v in rsv_triples],
                                       np.int32), b, device=device)
    e, _ = sc.S.from_bytes_any(bt.byte_plane_np(dig, b, device))
    r = sc.S._bytes_to_limbs(r_bytes).to(lb.DTYPE)
    s = sc.S._bytes_to_limbs(bt.byte_plane_np(
        _rows_of_ints([s for _, s, _ in rsv_triples]), b, device)).to(
            lb.DTYPE)
    xb, yb, status = _recover_core(r_bytes, recid, e, r, s)
    xs, ys = _plane_rows(xb, n), _plane_rows(yb, n)
    status = status[:n].cpu().numpy()
    out = []
    for i in range(n):
        if status[i] != ec.OK:
            out.append(None)
            continue
        point = (int.from_bytes(xs[i].tobytes(), "big"),
                 int.from_bytes(ys[i].tobytes(), "big"))
        try:
            out.append(keysmod.PublicKey(point))
        except keysmod.KeyError_:
            out.append(None)
    return out


# Single-item conveniences -------------------------------------------------

def sign(priv, digest, rand=None, opts=None, device=None):
    return sign_batch([priv], [digest], rand=rand, opts=opts,
                      device=device)[0]


def verify(pub, digest, sig, opts=None, device=None):
    return verify_batch([pub], [digest], [sig], opts=opts, device=device)[0]


def recover_public_key(digest, r, s, v, device=None):
    if not 0 <= v <= 3:
        raise ValueError("invalid recovery id")
    if r == 0 or s == 0 or r >= N or s >= N:
        raise ValueError("invalid r or s")
    return recover_batch([digest], [(r, s, v)], device=device)[0]
