"""The port's ECDSA signing slice on the CPU: the constant-time fixed-base
function, sign, recover, keyed verify and the list APIs.

- `base_windowed_add_plain` against the python-int oracle `tests/gold.py`
  on edge scalars, and `table.scalar_base_mult` through its wrapper;
- the RFC 6979 vectors byte-exact through `sign_batch` and
  `sign_batch_arrays`, `sign_batch` under `RFC6979SHA256` equal to
  `sign_batch_arrays` under every encoding and never entering the native
  DRBG, and the resample path through both (a candidate rejected at the
  nonce wrapper is followed by the lane's next DRBG candidate);
- sign -> recover round trips, with a crafted recovery id 2/3 lane;
- keyed-verify statuses, with the JAX package's `PubkeyCache` carried
  across by `convert`, and the off-curve key that the port's cache rejects.

Every comparison is exact.
"""

import csv
import hashlib
import os

import numpy as np
import pytest
import torch

import gold
from secp256k1_tpu.models import codecs as jcodecs
from secp256k1_tpu.models import ecdsa as jecdsa
from secp256k1_tpu.models.tuplehash import TupleHashXOF128 as JaxTupleHash
from secp256k1_tpu_torch import convert, native
from secp256k1_tpu_torch.models import codecs, ecdsa, keys
from secp256k1_tpu_torch.models.rfc6979 import DrbgRFC6979, RFC6979SHA256
from secp256k1_tpu_torch.models.tuplehash import TupleHashXOF128
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import config as cfg
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
N, P = hc.N, hc.P
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")

# Edge scalars of the signed 8-bit recoding: small values, n-1, n-2, the
# top bit, (n>>1)+1, every byte 0x80 (the carry runs through every
# window) and two scalars with zero windows.
EDGE_KS = [0, 1, 2, N - 1, N - 2, 2**255 % N, (N >> 1) + 1,
           int("80" * 32, 16) % N, (1 << 200) | 5,
           int("01" + "00" * 30 + "01", 16)]


def _planes(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=torch.int32)


def _affine(point):
    out = []
    for x, y, z in zip(*(lb.limbs_to_int_batch(c) for c in point)):
        out.append(None if z == 0 else
                   (x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P))
    return out


def _python_sign(d, digest, k):
    """SEC1 4.1.3 with python ints and low s: (r, s, recovery id)."""
    e = int.from_bytes(digest[:32], "big") % N
    big_r = hc.mul(k, hc.G)
    r = big_r[0] % N
    s = pow(k, N - 2, N) * (e + r * d) % N
    v = (big_r[1] & 1) | (2 if big_r[0] >= N else 0)
    if s > N // 2:
        s, v = N - s, v ^ 1
    return r, s, v


def _rfc6979_k(d, digest, reads=1):
    e = int.from_bytes(digest[:32], "big") % N
    drbg = DrbgRFC6979(d.to_bytes(32, "big"), e.to_bytes(32, "big"))
    for _ in range(reads):
        k = int.from_bytes(drbg.read(32), "big")
    return k


def _ints(row):
    return (int.from_bytes(row[:32].tobytes(), "big"),
            int.from_bytes(row[32:64].tobytes(), "big"))


def test_python_sign_helper():
    r, s, v = _python_sign(7, bytes(32), 11)
    assert s <= N // 2 and 0 <= v <= 3 and r == hc.mul(11, hc.G)[0] % N


# ---------------------------------------------------------------------------
# The constant-time fixed-base function.
# ---------------------------------------------------------------------------

def test_base_windowed_add_plain_against_gold():
    rng = np.random.default_rng(606)
    ks = EDGE_KS + [int.from_bytes(rng.bytes(32), "big") % N
                    for _ in range(6)]
    k_t = _planes(ks)
    digits = tbl._signed_digits(k_t)
    # A magnitude-0 digit with the sign bit set is still zero.
    zero = (digits & 0xFFFF) == 0
    assert bool(zero[0].any()) and bool(zero[1:].any())
    marked = torch.where(zero, digits | (1 << 16), digits).contiguous()
    got = K.base_windowed_add_plain(marked, tbl.base_table(CPU))
    assert all(c.dtype == torch.int32 and c.shape == (16, len(ks))
               for c in got)
    assert _affine(got) == [gold.affine_mul(k, gold.GEN) for k in ks]

    K.reset_counts()
    via = tbl.scalar_base_mult(k_t)
    assert K.PLAIN_CALLS["base_windowed_add"] == 1
    assert K.LAUNCHES["base_windowed_add"] == 0
    assert all(torch.equal(a, b) for a, b in zip(via, got))


# ---------------------------------------------------------------------------
# RFC 6979 vectors, resampling, the entropy nonce path.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kat():
    with open(os.path.join(TESTDATA, "secp256k1_rfc6979_sha256.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    privs = [keys.PrivateKey(int(r[0])) for r in rows]
    digests = [hashlib.sha256(r[1].encode()).digest() for r in rows]
    priv_arr = np.stack([np.frombuffer(p.bytes(), np.uint8) for p in privs])
    dig_arr = np.stack([np.frombuffer(d, np.uint8) for d in digests])
    sigs, recid, status = ecdsa.sign_batch_arrays(priv_arr, dig_arr,
                                                  device=CPU)
    return {"rows": rows, "privs": privs, "digests": digests,
            "arrays": (sigs, recid, status)}


def test_rfc6979_vectors_sign_batch(kat):
    sigs = ecdsa.sign_batch(kat["privs"], kat["digests"],
                            rand=RFC6979SHA256(), device=CPU)
    assert len(sigs) == len(kat["rows"]) == 20
    assert [s.hex().upper() for s in sigs] == [r[2] for r in kat["rows"]]


def test_rfc6979_vectors_sign_batch_arrays(kat):
    sigs, recid, status = kat["arrays"]
    assert status.tolist() == [ec.OK] * len(kat["rows"])
    for row, sig, v, priv, digest in zip(kat["rows"], sigs, recid,
                                         kat["privs"], kat["digests"]):
        r, s = _ints(sig)
        assert codecs.build_asn1_signature(r, s).hex().upper() == row[2]
        k = _rfc6979_k(priv.scalar, digest)
        assert (r, s, int(v)) == _python_sign(priv.scalar, digest, k)


def test_sign_e2e_core_flags_bad_candidates_and_keys(monkeypatch):
    """Candidates 0, n and 2^256 - 1, given by the nonce wrapper, are
    flagged for a resample; keys 0 and n are bad keys; the valid lane
    equals python ints."""
    d, k = 0xC0FFEE, 0x1234567
    digest = hashlib.sha256(b"e2e core").digest()
    ks = [0, N, 2**256 - 1, k, k, k]
    ds = [d, d, d, 0, N, d]

    def plane(vals):
        rows = np.stack([np.frombuffer(v.to_bytes(32, "big"), np.uint8)
                         for v in vals])
        return torch.as_tensor(np.ascontiguousarray(rows.T))
    e_rows = [int.from_bytes(digest, "big") % N] * len(ks)
    seen = []

    def candidates(d_plane, e_plane, extra_plane, attempt):
        seen.append((d_plane, e_plane, extra_plane, attempt))
        return plane(ks)
    monkeypatch.setattr(K, "rfc6979_nonce", candidates)
    r_b, s_b, recid, resample, bad = ecdsa._sign_e2e_core(
        plane(ds), plane(e_rows), None, 0)
    assert len(seen) == 1 and seen[0][2] is None and seen[0][3] == 0
    assert torch.equal(seen[0][0], plane(ds))
    assert resample.tolist() == [True, True, True, False, False, False]
    assert bad.tolist() == [False, False, False, True, True, False]
    r = int.from_bytes(bytes(r_b[:, 5].to(torch.uint8).tolist()), "big")
    s = int.from_bytes(bytes(s_b[:, 5].to(torch.uint8).tolist()), "big")
    assert (r, s, int(recid[5])) == _python_sign(d, digest, k)


@pytest.fixture(scope="module")
def rfc_lanes(kat):
    """The 20 RFC 6979 vectors and 12 random keys and digests, with
    `sign_batch_arrays`' rows and recovery ids for them."""
    rng = np.random.default_rng(1806)
    privs = kat["privs"] + [
        keys.PrivateKey(int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1)
        for _ in range(12)]
    digests = kat["digests"] + [hashlib.sha256(b"lane %d" % i).digest()
                                for i in range(12)]
    sigs, recid, status = ecdsa.sign_batch_arrays(
        np.stack([np.frombuffer(p.bytes(), np.uint8) for p in privs]),
        np.stack([np.frombuffer(d, np.uint8) for d in digests]), device=CPU)
    assert status.tolist() == [ec.OK] * len(privs)
    return privs, digests, sigs, recid


@pytest.mark.parametrize("encoding", list(cfg.SignatureEncoding),
                         ids=lambda e: e.name)
def test_sign_batch_rfc6979_equals_sign_batch_arrays(rfc_lanes, encoding):
    """`sign_batch` under `RFC6979SHA256` gives `sign_batch_arrays`' (r, s,
    v) in the encoding asked for, byte for byte, which are the python-int
    signer's with the nonce of RFC 6979's first read."""
    privs, digests, sigs, recid = rfc_lanes
    got = ecdsa.sign_batch(privs, digests, rand=RFC6979SHA256(),
                           opts=cfg.ECDSAOptions(encoding=encoding),
                           device=CPU)
    build = {cfg.SignatureEncoding.ASN1: codecs.build_asn1_signature,
             cfg.SignatureEncoding.COMPACT: codecs.build_compact_signature,
             cfg.SignatureEncoding.COMPACT_RECOVERABLE:
                 codecs.build_compact_recoverable_signature}[encoding]
    for sig, row, v, priv, digest in zip(got, sigs, recid, privs, digests):
        r, s = _ints(row)
        want = (r, s, int(v)) if encoding.name.endswith("RECOVERABLE") \
            else (r, s)
        assert sig == build(*want)
        k = _rfc6979_k(priv.scalar, digest)
        assert (r, s, int(v)) == _python_sign(priv.scalar, digest, k)


def test_sign_batch_rfc6979_never_enters_the_native_drbg(monkeypatch, kat):
    """Under `RFC6979SHA256` every nonce comes from the DRBG kernel's
    wrapper: the native DRBG refuses every call and the signatures are
    still the vectors'."""
    def refuse(*args, **kwargs):
        raise RuntimeError("the native DRBG was entered")
    monkeypatch.setattr(native, "rfc6979_nonce_batch", refuse)
    monkeypatch.setattr(native, "rfc6979_continue", refuse)
    K.reset_counts()
    sigs = ecdsa.sign_batch(kat["privs"], kat["digests"],
                            rand=RFC6979SHA256(), device=CPU)
    assert K.PLAIN_CALLS["rfc6979_nonce"] > 0
    assert [s.hex().upper() for s in sigs] == [r[2] for r in kat["rows"]]


def test_sign_batch_rfc6979_reads_the_leftmost_32_bytes():
    """A 64-byte (sha512) digest signs as the python-int signer on its
    leftmost 32 bytes; a digest under 32 bytes raises before any nonce."""
    priv = keys.PrivateKey(0xD1CE)
    digest = hashlib.sha512(b"wide digest").digest()
    opts = cfg.ECDSAOptions(
        hash="sha512", encoding=cfg.SignatureEncoding.COMPACT_RECOVERABLE)
    sig, = ecdsa.sign_batch([priv], [digest], rand=RFC6979SHA256(),
                            opts=opts, device=CPU)
    k = _rfc6979_k(priv.scalar, digest)
    assert codecs.parse_compact_recoverable_signature(sig) == \
        _python_sign(priv.scalar, digest[:32], k)
    K.reset_counts()
    for hash_name in ("sha256", "unsized"):
        with pytest.raises(ValueError):
            ecdsa.sign_batch([priv], [digest[:31]], rand=RFC6979SHA256(),
                             opts=cfg.ECDSAOptions(hash=hash_name),
                             device=CPU)
    assert K.PLAIN_CALLS["rfc6979_nonce"] == 0


@pytest.mark.parametrize("entry", ["arrays", "list"])
def test_sign_batch_arrays_resample_continues_the_drbg(monkeypatch, entry):
    """A lane whose first candidate is rejected (n, 0) signs with the next
    candidate of its own DRBG, as the per-lane rejection loop does; through
    `sign_batch_arrays` and through `sign_batch` under `RFC6979SHA256`."""
    privs = [0xA1, 0xB2, 0xC3]
    digests = [hashlib.sha256(b"resample %d" % i).digest() for i in range(3)]
    real = K.rfc6979_nonce

    def first_rejected(d_plane, e_plane, extra_plane, attempt):
        k = real(d_plane, e_plane, extra_plane, attempt)
        if attempt == 0:
            k = k.clone()
            k[:, 1] = torch.as_tensor(list(N.to_bytes(32, "big")),
                                      dtype=torch.uint8)
            k[:, 2] = 0
        return k
    monkeypatch.setattr(K, "rfc6979_nonce", first_rejected)
    if entry == "arrays":
        sigs, recid, status = ecdsa.sign_batch_arrays(
            np.stack([np.frombuffer(d.to_bytes(32, "big"), np.uint8)
                      for d in privs]),
            np.stack([np.frombuffer(d, np.uint8) for d in digests]),
            device=CPU)
        assert status.tolist() == [ec.OK] * 3
        got = [(*_ints(sig), int(v)) for sig, v in zip(sigs, recid)]
    else:
        opts = cfg.ECDSAOptions(
            encoding=cfg.SignatureEncoding.COMPACT_RECOVERABLE)
        got = [codecs.parse_compact_recoverable_signature(sig)
               for sig in ecdsa.sign_batch(
                   [keys.PrivateKey(d) for d in privs], digests,
                   rand=RFC6979SHA256(), opts=opts, device=CPU)]
    for i, (d, digest) in enumerate(zip(privs, digests)):
        k = _rfc6979_k(d, digest, reads=1 if i == 0 else 2)
        assert got[i] == _python_sign(d, digest, k)


def test_sign_batch_arrays_bad_keys():
    priv = np.zeros((3, 32), np.uint8)
    priv[1] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)
    priv[2, 31] = 5
    sigs, recid, status = ecdsa.sign_batch_arrays(
        priv, np.full((3, 32), 7, np.uint8), device=CPU)
    assert status.tolist() == [ec.ERR_INVALID_SCALAR] * 2 + [ec.OK]
    assert not sigs[:2].any() and not recid[:2].any() and sigs[2].any()


def test_tuplehash_matches_jax():
    for items in ([b""], [b"key", bytes(32), b"\x01" * 40]):
        a, b = TupleHashXOF128(b"S"), JaxTupleHash(b"S")
        for it in items:
            a.write(it)
            b.write(it)
        assert a.read(64) == b.read(64)


def test_entropy_nonces():
    """rand=<reader>: the TupleHash nonce of (key, entropy, e); all-zero
    entropy still separates keys and messages."""
    class ZeroReader:
        def read(self, n):
            return bytes(n)

    p1, p2 = keys.PrivateKey(0x14B022E892CF8614), keys.PrivateKey(0x77)
    d1, d2 = hashlib.sha256(b"m1").digest(), hashlib.sha256(b"m2").digest()
    lanes = [(p1, d1), (p1, d1), (p1, d2), (p2, d1)]
    opts = cfg.ECDSAOptions(encoding=cfg.SignatureEncoding.COMPACT_RECOVERABLE)
    sigs = ecdsa.sign_batch([p for p, _ in lanes], [d for _, d in lanes],
                            rand=ZeroReader(), opts=opts, device=CPU)
    assert sigs[0] == sigs[1] and len({sigs[0], sigs[2], sigs[3]}) == 3
    for sig, (priv, digest) in zip(sigs, lanes):
        e = int.from_bytes(digest, "big") % N
        k = keys.sample_random_scalar(
            ecdsa._nonce_reader(ZeroReader(), priv, e))
        r, s, v = codecs.parse_compact_recoverable_signature(sig)
        assert (r, s, v) == _python_sign(priv.scalar, digest, k)


# ---------------------------------------------------------------------------
# Recovery.
# ---------------------------------------------------------------------------

def _recid2_lane():
    """(digest, r, s, recid, Q) with R.x = r + n in [n, p): only recovery
    ids 2 and 3 reach it.  Q = r^-1 (s R - e G)."""
    x = N
    while True:
        x += 1
        big_r = hc.lift_x(x, True)
        if big_r is not None:
            break
    r = x - N
    digest = hashlib.sha256(b"recid 2 or 3").digest()
    e = int.from_bytes(digest, "big") % N
    s = 0x1234567890ABCDEF1234
    r_inv = pow(r, N - 2, N)
    q = hc.add(hc.mul(s * r_inv % N, big_r),
               hc.neg(hc.mul(e * r_inv % N, hc.G)))
    return digest, r, s, 2 | (big_r[1] & 1), q


def test_sign_then_recover(kat):
    sigs, recid, _ = kat["arrays"]
    digests = list(kat["digests"])
    triples = [(*_ints(sig), int(v)) for sig, v in zip(sigs, recid)]
    want = [p.public_key for p in kat["privs"]]
    digest, r, s, v, q = _recid2_lane()
    digests += [digest, digest, digests[0], digests[0]]
    triples += [(r, s, v), (r, s, v ^ 2), triples[0][:2] + (4,),
                (0,) + triples[0][1:]]
    got = ecdsa.recover_batch(digests, triples, device=CPU)
    assert got[:len(want)] == want
    assert got[len(want)] == keys.PublicKey(q)
    assert got[len(want) + 1] != keys.PublicKey(q)
    assert got[-2:] == [None, None]
    with pytest.raises(ValueError):
        ecdsa.recover_public_key(digest, r, s, 4, device=CPU)


# ---------------------------------------------------------------------------
# Keyed verify and the list APIs.
# ---------------------------------------------------------------------------

def test_pubkey_cache_rejects_what_is_not_a_curve_point():
    g = (hc.GX, hc.GY)
    sec1 = np.stack([np.frombuffer(hc.encode_point(g, c).ljust(65, b"\0"),
                                   np.uint8) for c in (True, False)])
    cache = ecdsa.PubkeyCache.from_sec1_arrays(sec1, device=CPU)
    assert cache.n_keys == 2 and torch.equal(cache.qx[:, 0], cache.qx[:, 1])
    for bad in ((hc.GX, hc.GY + 1), (hc.GX + P, hc.GY), None):
        with pytest.raises(keys.KeyError_):
            ecdsa.PubkeyCache([g, bad], device=CPU)
    with pytest.raises(ValueError):
        ecdsa.PubkeyCache([], device=CPU)
    # The JAX package's cache takes the off-curve pair unchecked; carried
    # across, the port refuses it.
    jcache = jecdsa.PubkeyCache([g, (hc.GX, hc.GY + 1)])
    with pytest.raises(keys.KeyError_):
        convert.pubkey_cache_to_torch(np.asarray(jcache.qx),
                                      np.asarray(jcache.qy))


def test_keyed_verify_with_the_jax_cache(kat):
    """The JAX cache's planes carried across by `convert`, then one keyed
    batch with corrupted lanes, every status exact."""
    sigs, _, _ = kat["arrays"]
    jcache = jecdsa.PubkeyCache.from_sec1_arrays(np.stack([
        np.frombuffer(p.public_key.compressed_bytes(), np.uint8)
        for p in kat["privs"]]))
    cache = convert.pubkey_cache_to_torch(np.asarray(jcache.qx),
                                          np.asarray(jcache.qy), device=CPU)
    assert cache.n_keys == jcache.n_keys
    assert np.array_equal(convert.plane_from_torch(cache.qx),
                          np.asarray(jcache.qx))
    assert np.array_equal(convert.plane_from_torch(cache.qy),
                          np.asarray(jcache.qy))

    n = len(kat["rows"])
    ders = [codecs.build_asn1_signature(*_ints(s)) for s in sigs]
    key_idx = np.arange(n)
    digests = np.stack([np.frombuffer(d, np.uint8) for d in kat["digests"]])
    want = np.full((n,), ec.OK, np.int32)
    key_idx[1], want[1] = n, ec.ERR_INVALID_PUBLIC_KEY
    key_idx[2], want[2] = -1, ec.ERR_INVALID_PUBLIC_KEY
    key_idx[3], want[3] = 4, ec.ERR_V_NEQ_R                # another key
    digests[5, 9] ^= 4
    want[5] = ec.ERR_V_NEQ_R
    ders[6] = b"\x31" + ders[6][1:]
    want[6] = ec.ERR_INVALID_ENCODING
    r, s = _ints(sigs[7])
    ders[7] = codecs.build_asn1_signature(r, N - s)
    want[7] = ec.ERR_MALLEABLE
    ders[8] = codecs.build_asn1_signature(N, 1)
    want[8] = ec.ERR_INVALID_SCALAR
    der_arr = np.zeros((n, 73), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, der in enumerate(ders):
        der_arr[i, :len(der)] = np.frombuffer(der, np.uint8)
        lens[i] = len(der)
    got = ecdsa.verify_batch_arrays_keyed(cache, key_idx, digests, der_arr,
                                          lens, reject_malleable=True)
    assert got.tolist() == want.tolist()


def test_verify_batch_status_asn1(kat):
    privs, digests = kat["privs"][:6], list(kat["digests"][:6])
    sigs = [codecs.build_asn1_signature(*_ints(s))
            for s in kat["arrays"][0][:6]]
    r, s = _ints(kat["arrays"][0][2])
    sigs[2] = codecs.build_asn1_signature(r, N - s)         # high s
    sigs[3] = sigs[3][:-1]                                  # truncated
    digests[4] = digests[4][:20]                            # short digest
    digests[5] = hashlib.sha256(b"other").digest()
    pubs = [p.public_key for p in privs]
    opts = cfg.ECDSAOptions(reject_malleable=True)
    got = ecdsa.verify_batch_status(pubs, digests, sigs, opts=opts,
                                    device=CPU)
    assert got == [ec.OK, ec.OK, ec.ERR_MALLEABLE, ec.ERR_INVALID_ENCODING,
                   ec.ERR_INVALID_DIGEST, ec.ERR_V_NEQ_R]


def test_verify_batch_compact_recoverable(kat):
    sigs, recid, _ = kat["arrays"]
    privs, digests = kat["privs"][:4], kat["digests"][:4]
    enc = [codecs.build_compact_recoverable_signature(*_ints(s), int(v))
           for s, v in zip(sigs[:4], recid[:4])]
    enc[1] = enc[1][:-1] + bytes([enc[1][-1] ^ 1])          # wrong parity
    enc[2] = enc[2][:64]                                    # no recovery id
    opts = cfg.ECDSAOptions(encoding=cfg.SignatureEncoding.COMPACT_RECOVERABLE)
    got = ecdsa.verify_batch_status([p.public_key for p in privs], digests,
                                    enc, opts=opts, device=CPU)
    assert got == [ec.OK, ec.ERR_VERIFY_FAILED, ec.ERR_INVALID_ENCODING,
                   ec.OK]


def test_codecs_and_keys_match_jax():
    for r, s in ((1, 1), (2**255, N - 1)):
        c = codecs.build_compact_signature(r, s)
        assert c == jcodecs.build_compact_signature(r, s)
        assert codecs.parse_compact_signature(c) == (r, s)
        cr = codecs.build_compact_recoverable_signature(r, s, 3)
        assert codecs.parse_compact_recoverable_signature(cr) == \
            jcodecs.parse_compact_recoverable_signature(cr)
    for bad in (bytes(64), N.to_bytes(32, "big") * 2, bytes(63)):
        with pytest.raises(codecs.CodecError):
            codecs.parse_compact_signature(bad)
    priv = keys.PrivateKey(0xDEADBEEF)
    spki = priv.public_key.asn1_bytes()
    assert spki == jcodecs.build_asn1_public_key(priv.public_key.bytes())
    assert keys.PublicKey.from_asn1(spki) == priv.public_key
    assert keys.PublicKey.from_bytes(priv.public_key.compressed_bytes()) \
        == priv.public_key
    with pytest.raises(keys.KeyError_):
        keys.PrivateKey(N)
    with pytest.raises(codecs.CodecError):
        codecs.parse_asn1_public_key_bytes(spki[:-1])
