"""The port's ECDSA verify slice, end to end on the CPU.

Every Wycheproof ECDSA SHA-256 and SHA-512 vector goes through the port's
`verify_raw_batch_status` and through `verify_batch_arrays` with 33-byte and
65-byte keys, under the per-vector checks that `tests/test_wycheproof.py`
applies to the JAX package (validity, and the error class the flags pin
down), with exact status parity between the arrays and raw paths.  The host
stage is held to the JAX package's own `_e2e_host_parse` byte for byte.  The
special cases (the r + n < p branch, long digests, `reject_malleable`, bad
prefixes, `pub_lens`, chunking) run on one small batch.
"""

import hashlib

import numpy as np
import pytest
import torch

from secp256k1_tpu.models import codecs as jcodecs
from secp256k1_tpu.models import ecdsa as jecdsa
from secp256k1_tpu_torch.models import codecs, ecdsa
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc
from ecdsa_cases import big_r_triple
from test_wycheproof import (SIG_FLAGS_ALWAYS_VALID, SIG_FLAGS_ASN1_ONLY,
                             SIG_FLAGS_MAY_REJECT_EARLY,
                             SIG_FLAGS_MUST_REJECT_EARLY,
                             _expected_device_errors, _hash, load)

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

FILES = ["ecdsa_secp256k1_sha256_test.json",
         "ecdsa_secp256k1_sha512_test.json"]
CPU = "cpu"


def _early(sig):
    """(parsed (r, s) or None, early status) from the port's parser."""
    try:
        return codecs.parse_asn1_signature(sig), ec.OK
    except codecs.ScalarError:
        return None, ec.ERR_INVALID_SCALAR
    except codecs.CodecError:
        return None, ec.ERR_INVALID_ENCODING


def _arrays(rows, compressed):
    n = len(rows)
    width = 33 if compressed else 65
    pubs = np.zeros((n, width), np.uint8)
    digs = np.zeros((n, 64), np.uint8)                 # SHA-256 rows padded
    sigs = np.zeros((n, max(len(r["sig"]) for r in rows)), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, r in enumerate(rows):
        raw = hc.encode_point(r["point"], compressed=compressed)
        pubs[i] = np.frombuffer(raw, np.uint8)
        digs[i, :len(r["digest"])] = np.frombuffer(r["digest"], np.uint8)
        sigs[i, :len(r["sig"])] = np.frombuffer(r["sig"], np.uint8)
        lens[i] = len(r["sig"])
    return pubs, digs, sigs, lens


@pytest.fixture(scope="module")
def wycheproof():
    """Both files' vectors through the raw path and both arrays paths, one
    batch per path."""
    rows = []
    for fname in FILES:
        data = load(fname)
        n_tests = 0
        for group in data["testGroups"]:
            point = hc.decode_point(
                bytes.fromhex(group["publicKey"]["uncompressed"]))
            for t in group["tests"]:
                n_tests += 1
                sig = bytes.fromhex(t["sig"])
                parsed, early = _early(sig)
                rows.append({"file": fname, "point": point, "sig": sig,
                             "digest": _hash(group["sha"],
                                             bytes.fromhex(t["msg"])),
                             "parsed": parsed, "early": early,
                             "flags": set(t["flags"]),
                             "result": t["result"], "tcid": t["tcId"]})
        assert n_tests == data["numberOfTests"]
    dev = [r for r in rows if r["parsed"] is not None]
    raw = ecdsa.verify_raw_batch_status(
        [r["point"] for r in dev], [r["digest"] for r in dev],
        [r["parsed"] for r in dev], device=CPU)
    for r, st in zip(dev, raw):
        r["raw"] = st
    out = {"rows": rows}
    for width, compressed in ((33, True), (65, False)):
        arrays = _arrays(rows, compressed)
        out[width] = (arrays, ecdsa.verify_batch_arrays(*arrays, device=CPU))
    return out


@pytest.mark.parametrize("fname", FILES)
def test_wycheproof_raw_path(wycheproof, fname):
    n_checked = 0
    for r in wycheproof["rows"]:
        if r["file"] != fname:
            continue
        flags, must_fail = r["flags"], r["result"] != "valid"
        has_valid = bool(flags & SIG_FLAGS_ALWAYS_VALID)
        tcid = r["tcid"]
        if r["parsed"] is None:
            assert not has_valid, f"tcId {tcid}: valid sig failed to parse"
            assert flags & (SIG_FLAGS_MUST_REJECT_EARLY
                            | SIG_FLAGS_MAY_REJECT_EARLY), tcid
            if flags & SIG_FLAGS_ASN1_ONLY:
                assert r["early"] == ec.ERR_INVALID_ENCODING, tcid
            assert must_fail, tcid
        else:
            assert not (flags & SIG_FLAGS_MUST_REJECT_EARLY), tcid
            st = r["raw"]
            assert (st == ec.OK) == (not must_fail), \
                f"tcId {tcid}: status {st} result {r['result']} {flags}"
            if st != ec.OK:
                assert not has_valid
                expected = _expected_device_errors(flags)
                if expected:
                    assert st in expected, f"tcId {tcid}: {st} {flags}"
        n_checked += 1
    assert n_checked == load(fname)["numberOfTests"]


@pytest.mark.parametrize("width", [33, 65])
@pytest.mark.parametrize("fname", FILES)
def test_wycheproof_arrays_parity(wycheproof, fname, width):
    """Exact status parity of the arrays path with the raw path plus the
    host parser, as `test_wycheproof_ecdsa_verify_arrays_parity` checks
    for the JAX package (SHA-512 rows exercise the 256-bit truncation)."""
    _, got = wycheproof[width]
    rows = wycheproof["rows"]
    sel = np.asarray([r["file"] == fname for r in rows])
    want = np.asarray([r.get("raw", r["early"]) for r in rows], np.int32)
    assert got.dtype == np.int32 and got.shape == want.shape
    mism = np.nonzero((got != want) & sel)[0]
    assert mism.size == 0, (mism[:5], got[mism[:5]], want[mism[:5]])


@pytest.mark.parametrize("width", [33, 65])
def test_host_parse_matches_jax(wycheproof, width):
    """The host stage (strict DER, prefix checks, inert fill) equals the
    JAX package's on every Wycheproof row."""
    pubs, _, sigs, lens = wycheproof[width][0]
    got = ecdsa._e2e_host_parse(pubs, sigs, lens)
    want = jecdsa._e2e_host_parse(pubs, sigs, lens)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_der_codec_matches_jax(wycheproof):
    """Same (r, s) or the same error class as the JAX package's parser."""
    for r in wycheproof["rows"]:
        try:
            want = jcodecs.parse_asn1_signature(r["sig"]), ec.OK
        except jcodecs.ScalarError:
            want = None, ec.ERR_INVALID_SCALAR
        except jcodecs.CodecError:
            want = None, ec.ERR_INVALID_ENCODING
        assert _early(r["sig"]) == want, r["tcid"]
    for r_, s_ in ((1, 1), (2**255, hc.N - 1), (0x80, 0x7F)):
        der = codecs.build_asn1_signature(r_, s_)
        assert der == jcodecs.build_asn1_signature(r_, s_)
        assert codecs.parse_asn1_signature(der) == (r_, s_)


# ---------------------------------------------------------------------------
# Special cases, on one small batch.
# ---------------------------------------------------------------------------

def _sign(d, digest, k):
    n = hc.N
    e = int.from_bytes(digest[:32], "big") % n
    r = hc.mul(k, hc.G)[0] % n
    return r, pow(k, n - 2, n) * (e + r * d) % n


def test_verify_impl_r_plus_n_branch():
    q, digest, r, s = big_r_triple()
    bad = hashlib.sha256(b"other").digest()
    got = ecdsa.verify_raw_batch_status(
        [q, q, q, q], [digest, bad, digest, digest],
        [(r, s), (r, s), (r + 1, s), (0, s)], device=CPU)
    assert got == [ec.OK, ec.ERR_V_NEQ_R, ec.ERR_V_NEQ_R,
                   ec.ERR_INVALID_SIGNATURE]


@pytest.fixture(scope="module")
def special():
    """A 24-lane 65-byte batch with per-lane cases and its statuses."""
    rng = np.random.default_rng(99)
    n = hc.N
    cases = []                    # (pub bytes, digest 48 B, der, want, want_rm)
    for i in range(16):
        d = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
        k = int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
        digest = hashlib.sha256(b"special %d" % i).digest() + rng.bytes(16)
        r, s = _sign(d, digest, k)
        low = min(s, n - s)
        point = hc.mul(d, hc.G)
        pub = hc.encode_point(point, compressed=i % 2 == 0)
        cases.append([pub, digest, codecs.build_asn1_signature(r, low),
                      ec.OK, ec.OK])
        if i == 3:                                  # high s
            cases[-1][2] = codecs.build_asn1_signature(r, n - low)
            cases[-1][4] = ec.ERR_MALLEABLE
        if i == 4:                                  # digest bytes 32.. ignored
            cases[-1][1] = digest[:32] + bytes(16)
        if i == 5:                                  # digest byte 31 counts
            cases[-1][1] = digest[:31] + bytes([digest[31] ^ 1]) + digest[32:]
            cases[-1][3] = cases[-1][4] = ec.ERR_V_NEQ_R
        if i in (6, 7):                             # bad prefixes
            cases[-1][0] = bytes([0x05 + i - 6]) + pub[1:]
            cases[-1][3] = cases[-1][4] = ec.ERR_INVALID_PUBLIC_KEY
        if i == 8:                                  # compressed, nonzero pad
            cases[-1][0] = pub + b"\x01" + bytes(31)
            cases[-1][3] = cases[-1][4] = ec.ERR_INVALID_PUBLIC_KEY
    q, digest, r, s = big_r_triple()
    cases.append([hc.encode_point(q), digest + bytes(16),
                  codecs.build_asn1_signature(r, s), ec.OK,
                  ec.ERR_MALLEABLE if s > n // 2 else ec.OK])
    cases.append([cases[0][0], cases[0][1], b"\x31" + cases[0][2][1:],
                  ec.ERR_INVALID_ENCODING, ec.ERR_INVALID_ENCODING])
    cases.append([cases[1][0], cases[1][1],
                  codecs.build_asn1_signature(n, 5),
                  ec.ERR_INVALID_SCALAR, ec.ERR_INVALID_SCALAR])
    while len(cases) < 24:
        cases.append(list(cases[len(cases) - 19]))
    m = len(cases)
    pubs = np.zeros((m, 65), np.uint8)
    digs = np.zeros((m, 48), np.uint8)
    sigs = np.zeros((m, 73), np.uint8)
    lens = np.zeros((m,), np.int32)
    for i, (pub, dig, der, _, _) in enumerate(cases):
        pubs[i, :len(pub)] = np.frombuffer(pub, np.uint8)
        digs[i] = np.frombuffer(dig, np.uint8)
        sigs[i, :len(der)] = np.frombuffer(der, np.uint8)
        lens[i] = len(der)
    plens = np.where(pubs[:, 0] == 0x04, 65, 33).astype(np.int32)
    plens[9] = 65 - plens[9] + 33                   # length disagrees
    plens[10] = 65 - plens[10] + 33
    want = np.asarray([c[3] for c in cases], np.int32)
    want_rm = np.asarray([c[4] for c in cases], np.int32)
    want_pl = want.copy()
    want_pl[[9, 10]] = ec.ERR_INVALID_PUBLIC_KEY
    arrays = (pubs, digs, sigs, lens)
    return {
        "arrays": arrays, "plens": plens, "want": want, "want_rm": want_rm,
        "want_pl": want_pl,
        "plain": ecdsa.verify_batch_arrays(*arrays, pub_lens=plens,
                                           device=CPU),
        "chunked": ecdsa.verify_batch_arrays(*arrays, pub_lens=plens,
                                             chunk_lanes=16, device=CPU),
        "malleable": ecdsa.verify_batch_arrays(*arrays,
                                               reject_malleable=True,
                                               device=CPU),
    }


def test_special_cases_statuses(special):
    """Long digests (leftmost 256 bits), bad prefixes, a nonzero pad on a
    compressed key in a 65-byte batch, malformed DER, r >= n, and the
    r + n < p lane, with pub_lens mismatches on two lanes."""
    got = special["plain"]
    assert np.array_equal(got, special["want_pl"]), \
        (got, special["want_pl"])


def test_chunked_equals_unchunked(special):
    assert np.array_equal(special["chunked"], special["plain"])


def test_reject_malleable(special):
    got = special["malleable"]
    assert np.array_equal(got, special["want_rm"]), (got, special["want_rm"])
    assert int((got == ec.ERR_MALLEABLE).sum()) >= 1


def test_compressed_batch_bad_prefixes():
    """33-byte keys: only 0x02 and 0x03 are accepted."""
    d, k = 0xC0FFEE, 0xBEEF
    digest = hashlib.sha256(b"prefixes").digest()
    r, s = _sign(d, digest, k)
    pub = hc.encode_point(hc.mul(d, hc.G), compressed=True)
    der = codecs.build_asn1_signature(r, s)
    prefixes = [pub[0], 0x04, 0x00, 0x06, pub[0] ^ 1]
    pubs = np.stack([np.frombuffer(bytes([p]) + pub[1:], np.uint8)
                     for p in prefixes])
    digs = np.tile(np.frombuffer(digest, np.uint8), (len(prefixes), 1))
    sigs = np.tile(np.frombuffer(der, np.uint8), (len(prefixes), 1))
    got = ecdsa.verify_batch_arrays(pubs, digs, sigs, device=CPU)
    assert got.tolist() == [ec.OK] + [ec.ERR_INVALID_PUBLIC_KEY] * 3 \
        + [ec.ERR_V_NEQ_R]


def test_hash_to_scalar_int():
    big = b"\xff" * 40
    assert ecdsa.hash_to_scalar_int(big) == (2**256 - 1) % hc.N
    assert ecdsa.hash_to_scalar_int(bytes(31) + b"\x07" + b"\x01") == 7
    with pytest.raises(ValueError):
        ecdsa.hash_to_scalar_int(bytes(31))
