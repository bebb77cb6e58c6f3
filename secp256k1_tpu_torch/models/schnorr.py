"""BIP-0340 Schnorr signatures, batched, on PyTorch.

The port of `secp256k1_tpu.models.schnorr`: x-only keys (even-y
convention), tagged hashes, aux-rand nonce derivation, sign with the
mandatory self-verify through (s - d*e)*G, and verify as R = s*G - e*P.
Signing's tagged hashes and the object API's challenge run on the host (the
batched entry points in one native call each); the array verify hashes its
challenge on the device (`K.bip340_challenge`), and every group operation
runs batched on the device.  The three k*G of signing (the key, the
nonce, the self-verify) are launches of the constant-time fixed-base
kernel; verify uses the GLV and public-digit fixed-base kernels, its core
replayed as one CUDA graph a width and message length on the GPU.

Entry points take `device=None`, which means the GPU, and raise when there
is none; the CPU runs only when the caller passes `device="cpu"`.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
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
from ..utils import errors as ec
from ..utils import graphs
from ..utils import hostcurve as hc
from ..utils import profiling
from .ecdsa import _plane_rows, _reduce_digest_np, _status_where

N = hc.N
P = hc.P
SCHNORR_PUBLIC_KEY_SIZE = 32
SCHNORR_SIGNATURE_SIZE = 64

TAG_AUX = "BIP0340/aux"
TAG_NONCE = "BIP0340/nonce"
TAG_CHALLENGE = "BIP0340/challenge"


def tagged_hash(tag: str, *vals: bytes) -> bytes:
    """BIP-0340 tagged hash SHA256(SHA256(tag) || SHA256(tag) || vals)."""
    ht = hashlib.sha256(tag.encode()).digest()
    h = hashlib.sha256()
    h.update(ht)
    h.update(ht)
    for v in vals:
        h.update(v)
    return h.digest()


def pre_hash_message(name: str, msg: bytes) -> bytes:
    """Domain-separated message pre-hash; rejects an empty separator."""
    if not name:
        raise ValueError("invalid domain separator")
    return tagged_hash(name, msg)


class SchnorrPublicKey:
    """x-only public key, held as its even-y lift."""

    __slots__ = ("point", "x_bytes_")

    def __init__(self, point):
        if point is None:
            raise ValueError("public key is the point at infinity")
        if point[1] & 1:
            point = (point[0], P - point[1])
        self.point = point
        self.x_bytes_ = point[0].to_bytes(32, "big")

    @classmethod
    def from_bytes(cls, data: bytes) -> "SchnorrPublicKey":
        if len(data) != SCHNORR_PUBLIC_KEY_SIZE:
            raise ValueError("invalid public key")
        p1 = hc.lift_x(int.from_bytes(data, "big"), want_odd=False)
        if p1 is None:
            raise ValueError("invalid public key")
        return cls(p1)

    @classmethod
    def from_ecdsa(cls, pub) -> "SchnorrPublicKey":
        return cls(pub.point)

    def bytes(self) -> bytes:
        return self.x_bytes_

    def __eq__(self, other):
        if not isinstance(other, SchnorrPublicKey):
            return NotImplemented
        return _hmac.compare_digest(self.x_bytes_, other.x_bytes_)

    def __hash__(self):
        return hash(self.x_bytes_)


class SchnorrPrivateKey:
    """Schnorr private key: d normalized so that d*G has an even y."""

    __slots__ = ("d", "orig_scalar", "public_key")

    def __init__(self, scalar: int):
        if not 1 <= scalar < N:
            raise ValueError("invalid private key")
        self.orig_scalar = scalar
        point = hc.mul(scalar, hc.G)
        self.public_key = SchnorrPublicKey(point)
        self.d = scalar if not point[1] & 1 else N - scalar

    @classmethod
    def from_bytes(cls, data: bytes) -> "SchnorrPrivateKey":
        if len(data) != 32:
            raise ValueError("invalid private key")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def from_ecdsa(cls, priv) -> "SchnorrPrivateKey":
        return cls(priv.scalar)

    def bytes(self) -> bytes:
        return self.orig_scalar.to_bytes(32, "big")

    def __eq__(self, other):
        if not isinstance(other, SchnorrPrivateKey):
            return NotImplemented
        return _hmac.compare_digest(self.bytes(), other.bytes())

    def __hash__(self):
        return hash(self.orig_scalar)


def generate_key(read_fn=None) -> SchnorrPrivateKey:
    read_fn = read_fn or os.urandom
    for _ in range(8):
        v = int.from_bytes(read_fn(32), "big")
        if 1 <= v < N:
            return SchnorrPrivateKey(v)
    raise ValueError("failed rejection sampling")


# ---------------------------------------------------------------------------
# Device cores.
# ---------------------------------------------------------------------------

def _base_mult_affine(k):
    """k*G for a secret scalar plane -> (x bytes, y odd)."""
    aff = pt.to_affine(tbl.scalar_base_mult(k))
    return fe.to_bytes(aff.x), fe.is_odd(aff.y)


def _schnorr_sign_stage1(d_bytes):
    """Key stage: d in [1, n), P = d*G, and d_even = -d where y(P) is odd.
    Returns (x(P) bytes, d_even bytes, bad_key)."""
    d = sc.S._bytes_to_limbs(d_bytes)
    bad = lb.geq_const(d, sc.S.m_limbs) | lb.is_zero(d)
    d_safe = lb.select(~bad, d, sc.one(d.shape[1:], d.device)).to(lb.DTYPE)
    aff = pt.to_affine(tbl.scalar_base_mult(d_safe))
    d_even = sc.select(~fe.is_odd(aff.y), d_safe, sc.neg(d_safe))
    return fe.to_bytes(aff.x), sc.to_bytes(d_even), bad


def _schnorr_sign_stage2(kp_bytes):
    """Nonce stage: R = k'*G, k' already reduced mod n by the host; k' = 0
    lanes are flagged and run with 1.  Returns (x(R) bytes, y(R) odd,
    k_zero)."""
    k = sc.S._bytes_to_limbs(kp_bytes)
    k_zero = lb.is_zero(k)
    k_safe = lb.select(~k_zero, k, sc.one(k.shape[1:], k.device)).to(
        lb.DTYPE)
    aff = pt.to_affine(tbl.scalar_base_mult(k_safe))
    return fe.to_bytes(aff.x), fe.is_odd(aff.y), k_zero


def _schnorr_sign_stage3(kp_bytes, r_odd, d_even_bytes, e_bytes, rx_bytes):
    """Closing stage: k = -k' where y(R) is odd, s = k + e*d, and the
    mandatory self-verify R' = (s - d*e)*G through a second k*G: even y and
    x(R') == x(R).  Returns (s bytes, ok)."""
    k = sc.S._bytes_to_limbs(kp_bytes).to(lb.DTYPE)
    d = sc.S._bytes_to_limbs(d_even_bytes).to(lb.DTYPE)
    e = sc.S._bytes_to_limbs(e_bytes).to(lb.DTYPE)
    k = sc.select(~r_odd, k, sc.neg(k))
    s = sc.add(k, sc.mul(e, d))
    f = sc.sub(s, sc.mul(d, e))
    r_fe, _ = fe.from_bytes_any(rx_bytes)
    ok = ~_schnorr_tail_bad(tbl.scalar_base_mult(f), r_fe)
    return sc.to_bytes(s), ok


def _schnorr_tail_bad(big_r, r_fe):
    """The verify tail: fail where R is the identity, its affine y is odd,
    or x(R) != r.  x(R) == r is checked projectively (X == r*Z), so the
    rescale is one batched inversion and one multiply for the y parity."""
    is_inf = pt.is_identity(big_r)
    y_odd = fe.is_odd(pt.affine_y(big_r))
    x_ok = fe.eq(big_r.x, fe.mul(r_fe, big_r.z))
    return is_inf | y_odd | ~x_ok


def _verify_status(bad):
    return _status_where(bad, ec.ERR_VERIFY_FAILED, torch.full(
        bad.shape, ec.OK, dtype=torch.int32, device=bad.device))


def _schnorr_verify_core(px, py, s, e_neg, r_fe):
    """R = s*G + (-e)*P; fail where R is the identity, y(R) is odd or
    x(R) != r."""
    p = pt.Point(px, py, fe.one(px.shape[1:], px.device))
    big_r = glv.double_scalar_mult_basepoint(s, e_neg, p)
    return _verify_status(_schnorr_tail_bad(big_r, r_fe))


def _schnorr_verify_e2e_core(pub_x_bytes, r_bytes, s_bytes, msg_bytes):
    """BIP-0340 verify from byte planes (`_schnorr_verify_e2e_body`),
    through a CUDA graph (`graphs.Cache.run`) where `_verify_graph_key`
    gives the planes one, else eagerly.  Returns the status plane."""
    planes = (pub_x_bytes, r_bytes, s_bytes, msg_bytes)
    key = _verify_graph_key(planes)
    if key is None:
        if pub_x_bytes.device.type == "cuda":
            VERIFY_GRAPHS["eager"] += 1
            profiling.current().how = "eager"
        return _schnorr_verify_e2e_body(*planes)
    out, how = _VERIFY_CACHE.run(key, _verify_body_tuple, planes)
    profiling.current().how = how
    return out[0]


# How the verify core's calls on the GPU ran (`graphs.Cache.counts`).
_VERIFY_CACHE = graphs.Cache()
VERIFY_GRAPHS = _VERIFY_CACHE.counts


def _verify_graph_key(planes):
    """The key of the CUDA graph that verifies these planes, or None where
    the body runs eagerly: planes off the GPU, or not all contiguous uint8
    on one device, the key, r and s [32, B] and the message [L, B]
    (`graphs.plane_width`).  The key holds what the body's launches depend
    on: the device, the width B, the message length L, and the GLV and
    fixed-base switches in force."""
    width = graphs.plane_width(planes[:3])
    msg = planes[3]
    length = msg.shape[0] if len(msg.shape) == 2 else -1
    if width is None or msg.device != planes[0].device \
            or graphs.plane_width([msg], rows=length) != width:
        return None
    return (planes[0].device, width, length, K.mega_enabled(),
            K.mega_signed_enabled(), tbl.base_signed_enabled(),
            tbl.base_window())


def _verify_body_tuple(pub_x_bytes, r_bytes, s_bytes, msg_bytes):
    return (_schnorr_verify_e2e_body(pub_x_bytes, r_bytes, s_bytes,
                                     msg_bytes),)


def _schnorr_verify_e2e_body(pub_x_bytes, r_bytes, s_bytes, msg_bytes):
    """BIP-0340 verify from byte planes (the key, r and s [32, B], the
    message [L, B]): the challenge e = H_challenge(r || P || m)
    (`K.bip340_challenge`), x-only key lift (even y), r < p and s < n, e
    reduced mod n, R = s*G - e*P, then the parity and x(R) == r checks."""
    want_odd = torch.zeros(pub_x_bytes.shape[1:], dtype=torch.bool,
                           device=pub_x_bytes.device)
    pub, pub_status = s11n.decompress(want_odd, pub_x_bytes)
    r_fe, r_red = fe.from_bytes_any(r_bytes)
    s_sc, s_red = sc.S.from_bytes_any(s_bytes)
    e, _ = sc.S.from_bytes_any(K.bip340_challenge(r_bytes, pub_x_bytes,
                                                  msg_bytes))
    big_r = glv.double_scalar_mult_basepoint(s_sc, sc.neg(e), pub)
    st = _verify_status(_schnorr_tail_bad(big_r, r_fe))
    bad_parse = (pub_status != ec.OK) | r_red | s_red
    return _status_where(bad_parse, ec.ERR_INVALID_ENCODING, st)


# ---------------------------------------------------------------------------
# Batched API.
# ---------------------------------------------------------------------------

def sign_batch(privs, msgs, rand=None, self_verify: bool = True,
               device=None) -> list:
    """BIP-0340 sign for a batch: one k'*G launch, and one more for the
    self-verify.  rand=None reads aux entropy from os.urandom; pass an
    object with .read(n) for fixed aux (e.g. the BIP-0340 vectors')."""
    device = bt.resolve_device(device)
    read = os.urandom if rand is None else rand.read
    n = len(privs)
    if len(msgs) != n:
        raise ValueError("privs and msgs differ in length")
    b = bt.bucket(n)
    k_primes = []
    for priv, msg in zip(privs, msgs):
        aux = read(32)
        if len(aux) != 32:
            raise ValueError("entropy source failure")
        t = bytes(a ^ c for a, c in zip(tagged_hash(TAG_AUX, aux),
                                        priv.d.to_bytes(32, "big")))
        k_prime = int.from_bytes(tagged_hash(
            TAG_NONCE, t, priv.public_key.bytes(), msg), "big") % N
        if k_prime == 0:
            raise ValueError("k' = 0")
        k_primes.append(k_prime)

    xb, y_odd = _base_mult_affine(bt.plane(k_primes, b, fill=1,
                                           device=device))
    xbs = bt.unplane_bytes(xb, n)
    y_odd = bt.unplane_flags(y_odd, n)
    sigs, factors = [], []
    for i, (priv, msg) in enumerate(zip(privs, msgs)):
        k = N - k_primes[i] if y_odd[i] else k_primes[i]
        e = int.from_bytes(tagged_hash(
            TAG_CHALLENGE, xbs[i], priv.public_key.bytes(), msg), "big") % N
        s = (k + e * priv.d) % N
        sigs.append(xbs[i] + s.to_bytes(32, "big"))
        factors.append((s - priv.d * e) % N)
    if self_verify:
        # (s - d*e)*G must give back R: one more batched k*G.
        xb2, y_odd2 = _base_mult_affine(bt.plane(factors, b, fill=1,
                                                 device=device))
        xbs2 = bt.unplane_bytes(xb2, n)
        y_odd2 = bt.unplane_flags(y_odd2, n)
        for i, sig in enumerate(sigs):
            if y_odd2[i] or xbs2[i] != sig[:32]:
                raise RuntimeError("failed to verify new sig")
    return sigs


def _tagged_hash_rows(tag: str, parts: list, n: int) -> np.ndarray:
    """Batched tagged hash over [n, w] u8 row arrays, one native call."""
    p = list(parts) + [None] * (3 - len(parts))
    return native.tagged_hash_batch(tag.encode(), p[0], p[1], p[2], n)


def sign_batch_arrays(priv_bytes: np.ndarray, msgs: np.ndarray,
                      aux: np.ndarray | None = None, device=None):
    """Batched BIP-0340 sign on numpy arrays.

    priv_bytes: [n, 32] u8 big-endian secret scalars; msgs: [n, L] u8 (one
    length); aux: [n, 32] u8 aux entropy, or None for os.urandom.  The host
    runs three batched native tagged hashes and the mod-n reductions; the
    key load (d*G and the even-y normalization), the nonce point R = k'*G,
    s = k + e*d and the (s - d*e)*G self-verify run on the device in three
    stages, one k*G launch each.  Returns (sigs [n, 64] u8 x(R) || s,
    status [n] int32); failed lanes get zeroed signatures."""
    device = bt.resolve_device(device)
    n = priv_bytes.shape[0]
    if priv_bytes.shape != (n, 32) or msgs.ndim != 2 or msgs.shape[0] != n:
        raise ValueError(f"expected [n, 32] keys and [n, L] messages, got "
                         f"{priv_bytes.shape} and {msgs.shape}")
    if aux is None:
        aux = np.frombuffer(os.urandom(32 * n), np.uint8).reshape(n, 32)
    if aux.shape != (n, 32):
        raise ValueError(f"expected [{n}, 32] aux, got {aux.shape}")
    b = bt.bucket(n)
    px_b, deven_b, bad_b = _schnorr_sign_stage1(
        bt.byte_plane_np(priv_bytes, b, device))
    pub_x = _plane_rows(px_b, n)
    d_even = _plane_rows(deven_b, n)
    bad_key = bad_b[:n].cpu().numpy()

    # t = d ^ H_aux(aux); k' = H_nonce(t || P || m) mod n.
    t = d_even ^ _tagged_hash_rows(TAG_AUX, [aux], n)
    kp = _reduce_digest_np(_tagged_hash_rows(TAG_NONCE, [t, pub_x, msgs], n))
    kp_plane = bt.byte_plane_np(kp, b, device)
    rx_b, r_odd_b, kz_b = _schnorr_sign_stage2(kp_plane)
    rx = _plane_rows(rx_b, n)
    k_zero = kz_b[:n].cpu().numpy()

    e_arr = _reduce_digest_np(
        _tagged_hash_rows(TAG_CHALLENGE, [rx, pub_x, msgs], n))
    s_b, ok_b = _schnorr_sign_stage3(kp_plane, r_odd_b, deven_b,
                                     bt.byte_plane_np(e_arr, b, device), rx_b)
    sigs = np.concatenate([rx, _plane_rows(s_b, n)], axis=1)
    status = np.where(ok_b[:n].cpu().numpy(), ec.OK,
                      ec.ERR_VERIFY_FAILED).astype(np.int32)
    status[k_zero] = ec.ERR_INVALID_SCALAR
    status[bad_key] = ec.ERR_INVALID_SCALAR
    sigs[status != ec.OK] = 0
    return sigs, status


def _challenge_digests(r_list, pub_bytes_list, msgs) -> list:
    """Per-lane challenge digests: one native call when every message has
    the same length, else per-lane hashing."""
    n = len(msgs)
    if n and len({len(m) for m in msgs}) == 1:
        def rows(items):
            return np.frombuffer(b"".join(items), np.uint8).reshape(n, -1)
        out = _tagged_hash_rows(TAG_CHALLENGE, [
            rows(r_list), rows(pub_bytes_list), rows(msgs)], n)
        return [out[i].tobytes() for i in range(n)]
    return [tagged_hash(TAG_CHALLENGE, r, p, m)
            for r, p, m in zip(r_list, pub_bytes_list, msgs)]


def verify_batch(pubs, msgs, sigs, device=None) -> list:
    """Batched BIP-0340 verify of `SchnorrPublicKey`s; returns [bool]."""
    device = bt.resolve_device(device)
    n = len(pubs)
    digests = _challenge_digests(
        [sig[:32] if len(sig) == SCHNORR_SIGNATURE_SIZE else bytes(32)
         for sig in sigs], [pub.bytes() for pub in pubs], list(msgs))
    lane_ok, s_ints, eneg_ints, r_ints = [], [], [], []
    for sig, dig in zip(sigs, digests):
        ok = len(sig) == SCHNORR_SIGNATURE_SIZE
        r = s = e = 1
        if ok:
            r = int.from_bytes(sig[:32], "big")
            s = int.from_bytes(sig[32:], "big")
            ok = r < P and s < N
            e = int.from_bytes(dig, "big") % N
        lane_ok.append(ok)
        r_ints.append(r if ok else 1)
        s_ints.append(s if ok else 1)
        eneg_ints.append((N - e) % N if ok else 1)
    b = bt.bucket(n)
    status = _schnorr_verify_core(
        bt.plane([p.point[0] for p in pubs], b, fill=hc.GX, device=device),
        bt.plane([p.point[1] for p in pubs], b, fill=hc.GY, device=device),
        bt.plane(s_ints, b, fill=1, device=device),
        bt.plane(eneg_ints, b, fill=1, device=device),
        bt.plane(r_ints, b, fill=1, device=device))
    return [ok and int(st) == ec.OK
            for ok, st in zip(lane_ok, bt.unplane_flags(status, n))]


def verify_batch_arrays(pub_x: np.ndarray, msgs: np.ndarray,
                        sigs: np.ndarray, chunk_lanes: int | None = None,
                        device=None) -> np.ndarray:
    """Batched BIP-0340 verify on numpy arrays.

    pub_x: [n, 32] u8 x-only keys; msgs: [n, L] u8 (one length); sigs:
    [n, 64] u8.  Returns an [n] bool array: `_verify_status_arrays` is
    OK.  chunk_lanes cuts the batch into chunks dispatched back to back."""
    device = bt.resolve_device(device)
    n = pub_x.shape[0]
    if sigs.shape != (n, 64) or pub_x.shape != (n, 32) \
            or msgs.ndim != 2 or msgs.shape[0] != n:
        raise ValueError(f"expected [n, 32] keys, [n, L] messages and "
                         f"[n, 64] sigs, got {pub_x.shape}, {msgs.shape}, "
                         f"{sigs.shape}")
    with profiling.entry("schnorr"):
        return _verify_status_arrays(pub_x, msgs, sigs, chunk_lanes,
                                     device) == ec.OK


def _verify_status_arrays(pub_x: np.ndarray, msgs: np.ndarray,
                          sigs: np.ndarray, chunk_lanes: int | None,
                          device: torch.device) -> np.ndarray:
    """[n] int32 statuses of BIP-0340 verify over checked rows (keys
    [n, 32], messages [n, L], sigs [n, 64]): OK, ERR_INVALID_ENCODING
    where the key does not lift or r >= p or s >= n, ERR_VERIFY_FAILED
    where the equation fails.  The challenge hash, parsing, the key lift
    and the group math run on the device (`_schnorr_verify_e2e_core`),
    chunk after chunk, each a `schnorr.planes` and a `schnorr.core` span
    (its `lanes`, and `how` on a card)."""
    n = pub_x.shape[0]
    on_card = device.type == "cuda"

    def dispatch(lo, hi):
        b = bt.bucket(hi - lo)
        with profiling.span("schnorr.planes"):
            planes = [bt.byte_plane_np(a, b, device) for a in (
                pub_x[lo:hi], sigs[lo:hi, :32], sigs[lo:hi, 32:],
                msgs[lo:hi])]
        with profiling.span("schnorr.core", on_card) as sp:
            sp.lanes = hi - lo
            return _schnorr_verify_e2e_core(*planes)

    chunk_lanes = bt.auto_chunk(n, chunk_lanes)
    if chunk_lanes is None or n <= chunk_lanes:
        spans = [(0, n)]
    else:
        spans = [(lo, min(lo + chunk_lanes, n))
                 for lo in range(0, n, chunk_lanes)]
    outs = [dispatch(lo, hi) for lo, hi in spans]
    with profiling.span("schnorr.readback"):
        return np.concatenate([o[:hi - lo].cpu().numpy()
                               for o, (lo, hi) in zip(outs, spans)]
                              ).astype(np.int32)


# Single-item conveniences -------------------------------------------------

def sign(priv, msg, rand=None, device=None):
    return sign_batch([priv], [msg], rand=rand, device=device)[0]


def verify(pub, msg, sig, device=None):
    return verify_batch([pub], [msg], [sig], device=device)[0]
