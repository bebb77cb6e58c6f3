"""The port's native host runtime: ctypes bindings to `hostcrypto.cpp`.

Batched SHA-256 (of whole rows, or each at its own length, between a common
prefix and suffix), the RFC 6979 HMAC-DRBG (first candidate of every lane,
with optional per-lane additional data, and the continuation of one lane
past a rejected candidate), BIP-0340 tagged hashes, the strict-DER ECDSA
signature parse (alone, or behind BIP-0066 for consensus verify) and the
strict-DER signature encode, one C call per batch.

The library is built at first use with `g++ -O2 -shared -fPIC` into

    build/secp256k1_tpu_torch/native/<hash of the source>/libhostcrypto.so

under the repository root, never beside the source.  A failed build
raises: the entry points that use this library have no pure-Python
fallback (the Python DRBG and DER parser stay only as references for the
tests).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "hostcrypto.cpp")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_ROOT = os.path.join(REPO_ROOT, "build", "secp256k1_tpu_torch",
                          "native")
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256()
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libhostcrypto.so")


def _build(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed.  Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        L = ctypes.CDLL(path)
        L.sha256_batch.argtypes = [_U8P, _I32P, ctypes.c_size_t,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t, _U8P]
        L.sha256_batch.restype = ctypes.c_uint64
        L.rfc6979_nonce_batch.argtypes = [_U8P, _U8P, _U8P,
                                          ctypes.c_size_t, _U8P, _U8P, _U8P]
        L.rfc6979_continue.argtypes = [_U8P, _U8P, _U8P]
        L.tagged_hash_batch.argtypes = [_U8P, _U8P, ctypes.c_size_t,
                                        _U8P, ctypes.c_size_t,
                                        _U8P, ctypes.c_size_t,
                                        ctypes.c_size_t, _U8P]
        for fn in (L.asn1_sig_parse_batch, L.bip0066_sig_parse_batch):
            fn.argtypes = [_U8P, _I32P, ctypes.c_size_t, ctypes.c_size_t,
                           _U8P, _U8P, _U8P]
        L.der_sig_encode_batch.argtypes = [_U8P, _U8P, ctypes.c_size_t,
                                           ctypes.c_uint8, _U8P, _I32P]
        for fn in (L.rfc6979_nonce_batch, L.rfc6979_continue,
                   L.tagged_hash_batch, L.asn1_sig_parse_batch,
                   L.bip0066_sig_parse_batch, L.der_sig_encode_batch):
            fn.restype = None
        _LIB = L
        return _LIB


def _p(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _rows(arr, width: int | None = None) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 2 or (width is not None and arr.shape[1] != width):
        raise ValueError(f"expected [B, {width or 'L'}] uint8 rows, got "
                         f"{arr.shape}")
    return arr


def lane_lengths(lens, b: int, width: int) -> np.ndarray:
    """lens as contiguous [b] int32; raises ValueError unless it is [b]
    integers in [0, width]."""
    lens = np.asarray(lens)
    if lens.shape != (b,) or not np.issubdtype(lens.dtype, np.integer):
        raise ValueError(f"lens must be [{b}] integers, got {lens.shape} "
                         f"{lens.dtype}")
    if b and (lens.min() < 0 or lens.max() > width):
        raise ValueError(f"lengths must lie in [0, {width}], got "
                         f"{lens.min()}..{lens.max()}")
    return np.ascontiguousarray(lens, dtype=np.int32)


def sha256_batch(msgs: np.ndarray, lens=None, prefix: bytes = b"",
                 suffix: bytes = b"", tally: dict | None = None) -> np.ndarray:
    """[B, L] u8 rows -> [B, 32] u8 digests of `prefix`, row i's first
    lens[i] bytes (lens [B] integers in [0, L]; None: every row whole),
    then `suffix`.  With `tally`, adds the compressions run to
    tally["blocks"].  Raises ValueError on a bad lens."""
    msgs = _rows(msgs)
    b, width = msgs.shape
    lens_p = None
    if lens is not None:
        lens = lane_lengths(lens, b, width)
        lens_p = lens.ctypes.data_as(_I32P)
    out = np.empty((b, 32), dtype=np.uint8)
    blocks = lib().sha256_batch(_p(msgs), lens_p, width, b, prefix,
                                len(prefix), suffix, len(suffix), _p(out))
    if tally is not None:
        tally["blocks"] += blocks
    return out


def rfc6979_nonce_batch(keys: np.ndarray, digests: np.ndarray,
                        extra: np.ndarray | None = None):
    """[B, 32] keys and [B, 32] digest scalars -> (first candidate k
    [B, 32], DRBG state V [B, 32], DRBG state K [B, 32]).

    `extra`, [B, 32] u8 rows or None, is RFC 6979 3.6 additional data:
    each lane's DRBG is seeded with key || digest || extra (96 bytes), as
    libsecp256k1's `nonce_function_rfc6979` seeds it when given 32 bytes of
    data.  None seeds with key || digest alone."""
    keys = _rows(keys, 32)
    digests = _rows(digests, 32)
    b = keys.shape[0]
    if digests.shape[0] != b:
        raise ValueError("keys and digests differ in length")
    if extra is not None:
        extra = _rows(extra, 32)
        if extra.shape[0] != b:
            raise ValueError("extra and keys differ in length")
    out = np.empty((b, 32), dtype=np.uint8)
    sv = np.empty((b, 32), dtype=np.uint8)
    sk = np.empty((b, 32), dtype=np.uint8)
    lib().rfc6979_nonce_batch(_p(keys), _p(digests),
                              None if extra is None else _p(extra), b,
                              _p(out), _p(sv), _p(sk))
    return out, sv, sk


def rfc6979_continue(state_v: np.ndarray, state_k: np.ndarray,
                     lane: int) -> np.ndarray:
    """The next candidate of one lane (RFC 6979 3.2 h.3, then h.2); updates
    that lane's rows of the state arrays in place."""
    for st in (state_v, state_k):
        if st.dtype != np.uint8 or not st.flags.c_contiguous \
                or st.ndim != 2 or st.shape[1] != 32:
            raise ValueError("state arrays must be contiguous [B, 32] uint8")
    out = np.empty((32,), dtype=np.uint8)
    lib().rfc6979_continue(_p(state_v[lane]), _p(state_k[lane]), _p(out))
    return out


def _sig_parse(fn_name: str, sigs: np.ndarray, lens: np.ndarray):
    sigs = _rows(sigs)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    b, max_len = sigs.shape
    if lens.shape != (b,):
        raise ValueError(f"lens must be [{b}], got {lens.shape}")
    r = np.empty((b, 32), dtype=np.uint8)
    s = np.empty((b, 32), dtype=np.uint8)
    status = np.empty((b,), dtype=np.uint8)
    getattr(lib(), fn_name)(_p(sigs), lens.ctypes.data_as(_I32P), max_len,
                            b, _p(r), _p(s), _p(status))
    return r, s, status


def asn1_sig_parse_batch(sigs: np.ndarray, lens: np.ndarray):
    """Batched strict-DER ECDSA signature parse.

    sigs: [B, max_len] u8 (rows zero-padded); lens: [B] actual sizes.
    Returns (r [B, 32], s [B, 32], status [B] u8): status 0 = ok,
    1 = malformed encoding, 2 = zero or out-of-range scalar, the classes of
    `models.codecs.parse_asn1_signature`."""
    return _sig_parse("asn1_sig_parse_batch", sigs, lens)


def bip0066_sig_parse_batch(sigs: np.ndarray, lens: np.ndarray):
    """Consensus intake in one pass over each row: BIP-0066 on the row of
    lens[i] bytes, its sighash byte included (a row longer than max_len
    fails), then the strict-DER parse of its first lens[i] - 1 bytes.

    Arguments and returns as `asn1_sig_parse_batch`; a BIP-0066 failure is
    status 1 with r = s = 0."""
    return _sig_parse("bip0066_sig_parse_batch", sigs, lens)


def der_sig_encode_batch(r: np.ndarray, s: np.ndarray, sighash: int):
    """Batched strict-DER encode (BIP-0066) with a trailing sighash byte.

    r, s: [B, 32] u8 big-endian rows.  Returns (rows [B, 73] u8, lens [B]
    int32): SEQUENCE { INTEGER r, INTEGER s } with minimal integers (a 0x00
    byte only in front of a set top bit), then the sighash byte; bytes past
    a row's length are zero.  73 is BIP-0066's maximum, reached only where
    both r and s have their top bit set."""
    r = _rows(r, 32)
    s = _rows(s, 32)
    b = r.shape[0]
    if s.shape[0] != b:
        raise ValueError("r and s differ in length")
    if not 0 <= sighash <= 255:
        raise ValueError(f"sighash {sighash} is not a byte")
    out = np.empty((b, 73), dtype=np.uint8)
    lens = np.empty((b,), dtype=np.int32)
    lib().der_sig_encode_batch(_p(r), _p(s), b, sighash, _p(out),
                               lens.ctypes.data_as(_I32P))
    return out, lens


def tagged_hash_batch(tag: bytes, p1: np.ndarray | None,
                      p2: np.ndarray | None, p3: np.ndarray | None,
                      batch: int) -> np.ndarray:
    """Batched BIP-0340 tagged hash SHA256(H(tag) || H(tag) || p1 || p2 ||
    p3) with up to three per-lane parts ([B, w] u8 rows; None skips)."""
    th = np.frombuffer(hashlib.sha256(tag).digest(), dtype=np.uint8).copy()

    def prep(p):
        if p is None:
            return np.empty((batch, 0), np.uint8), 0
        p = _rows(p)
        if p.shape[0] != batch:
            raise ValueError(f"part of {p.shape[0]} rows for {batch} lanes")
        return p, p.shape[1]

    a1, l1 = prep(p1)
    a2, l2 = prep(p2)
    a3, l3 = prep(p3)
    out = np.empty((batch, 32), dtype=np.uint8)
    lib().tagged_hash_batch(_p(th), _p(a1), l1, _p(a2), l2, _p(a3), l3,
                            batch, _p(out))
    return out
