"""The port's batched ECDH against Wycheproof, python ints and itself.

- Every vector of the Wycheproof ECDH files (`ecdh_secp256k1_test.json`,
  ASN.1 keys; `ecdh_secp256k1_webcrypto_test.json`, JWK keys): a vector
  whose key or scalar does not parse must be "invalid" or "acceptable";
  every other one goes through `ecdh_batch_arrays` (its key re-encoded
  SEC1-compressed) and must give status OK and its shared secret.
- `ecdh_batch_arrays` statuses on corrupted lanes: a bad prefix or an x
  with no square root -> ERR_INVALID_PUBLIC_KEY, k = 0 or k >= n ->
  ERR_INVALID_SCALAR, failed lanes zeroed.
- `ecdh_batch` against python ints, and `PrivateKey.ecdh` (a batch of
  one) against `ecdh_batch`.
- The three GLV engines (`set_mega_signed(False)`, `set_mega(False)`)
  give the default engine's bytes and statuses.

All on the CPU, through the kernels' plain versions; tolerance 0.
"""

import base64
import functools
import json
import os

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.models import codecs, ecdh, keys
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference_mode():
    """No autograd bookkeeping: the plain loops dispatch thousands of small
    ops, and inference mode takes about a quarter off each."""
    with torch.inference_mode():
        yield

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata", "wycheproof")
FILES = (("ecdh_secp256k1_test.json", "asn"),
         ("ecdh_secp256k1_webcrypto_test.json", "webcrypto"))


def _jwk_int(s):
    return int.from_bytes(base64.urlsafe_b64decode(s + "=" * (-len(s) % 4)),
                          "big")


def _parse_ecdh_public(group_encoding, t):
    """Returns a PublicKey or raises (the parse of
    tests/test_wycheproof.py on the port's codecs and keys)."""
    if group_encoding == "asn":
        point = codecs.parse_asn1_public_key_bytes(bytes.fromhex(t["public"]))
        return keys.PublicKey.from_bytes(point)
    jwk = t["public"]
    if jwk.get("kty") != "EC" or jwk.get("crv") != "P-256K":
        raise ValueError("wrong curve")
    x = _jwk_int(jwk["x"])
    y = _jwk_int(jwk["y"])
    if x >= hc.P or y >= hc.P:
        raise ValueError("coordinate out of range")
    return keys.PublicKey((x, y))


def _parse_ecdh_private(group_encoding, t):
    """The scalar, with `keys.PrivateKey`'s range check (without deriving
    the public key, a python-int k*G a vector)."""
    if group_encoding == "asn":
        v = int(t["private"], 16)
    else:
        v = _jwk_int(t["private"]["d"])
    if not 1 <= v < hc.N:
        raise keys.KeyError_("private key scalar out of range")
    return v


def _rows(vals, width):
    return np.frombuffer(b"".join(vals), np.uint8).reshape(-1, width)


@functools.cache
def _wycheproof():
    """Every vector of both files parsed: ([(file, tcId, result, shared hex
    or None where the parse failed)], the distinct (scalar, point) pairs,
    the pair of each parsed vector)."""
    vectors, pairs, pair_of = [], {}, {}
    for fname, encoding in FILES:
        with open(os.path.join(TESTDATA, fname)) as fh:
            data = json.load(fh)
        n_tests = 0
        for group in data["testGroups"]:
            for t in group["tests"]:
                n_tests += 1
                key = (fname, t["tcId"])
                try:
                    pub = _parse_ecdh_public(encoding, t)
                    priv = _parse_ecdh_private(encoding, t)
                except (ValueError, codecs.CodecError, keys.KeyError_):
                    vectors.append((key, t["result"], None))
                    continue
                pair = (priv, pub.point)
                pair_of[key] = pairs.setdefault(pair, len(pairs))
                vectors.append((key, t["result"], t["shared"]))
        assert n_tests == data["numberOfTests"]
    return vectors, list(pairs), pair_of


@functools.cache
def _default_engine_run():
    """One `ecdh_batch_arrays` call on the default engine: the distinct
    Wycheproof pairs, then the corrupted lanes of `_corrupted_batch` (in
    the same padded batch).  Returns (shared, status) of each part."""
    _, pairs, _ = _wycheproof()
    priv = _rows([k.to_bytes(32, "big") for k, _ in pairs], 32)
    pubs = _rows([hc.encode_point(p, compressed=True) for _, p in pairs], 33)
    bad_priv, bad_pubs, _, _ = _corrupted_batch()
    shared, status = ecdh.ecdh_batch_arrays(
        np.concatenate([priv, bad_priv]), np.concatenate([pubs, bad_pubs]),
        device="cpu")
    n = len(pairs)
    return (shared[:n], status[:n]), (shared[n:], status[n:])


def test_wycheproof_ecdh_every_vector():
    vectors, pairs, pair_of = _wycheproof()
    (shared, status), _ = _default_engine_run()
    assert shared.shape == (len(pairs), 32) and status.dtype == np.int32
    parsed = 0
    for key, result, want in vectors:
        if want is None:
            assert result in ("invalid", "acceptable"), \
                f"{key}: parse failed on a {result} vector"
            continue
        parsed += 1
        i = pair_of[key]
        assert status[i] == ec.OK, f"{key}: status {status[i]}"
        if result in ("valid", "acceptable"):
            assert shared[i].tobytes().hex() == want, f"{key}: shared"
        else:
            assert shared[i].tobytes().hex() != want, f"{key}: matched"
    assert parsed == len(pair_of) and len(pairs) < parsed


@functools.cache
def _corrupted_batch():
    """16 lanes: seeded keys and peers, then a bad prefix (lanes 1, 9), an
    x with no square root (2, 10), k = 0 (3), k = n (4), k = 2^256 - 1
    (5) and k = n - 1 (6, valid).  Returns (priv, pubs, expected shared
    rows, expected status)."""
    rng = np.random.default_rng(424242)
    lanes = 16
    ks = [int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1
          for _ in range(lanes)]
    peers = [hc.mul(int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1,
                    hc.G) for _ in range(lanes)]
    ks[6] = hc.N - 1
    x_bad = 5
    while pow((x_bad ** 3 + 7) % hc.P, (hc.P - 1) // 2, hc.P) != hc.P - 1:
        x_bad += 1
    priv = _rows([k.to_bytes(32, "big") for k in ks], 32).copy()
    pubs = _rows([hc.encode_point(p, compressed=True) for p in peers],
                 33).copy()
    status = np.full((lanes,), ec.OK, np.int32)
    for i in (1, 9):
        pubs[i, 0] = (0x04, 0x00)[i == 9]
        status[i] = ec.ERR_INVALID_PUBLIC_KEY
    for i in (2, 10):
        pubs[i, 1:] = np.frombuffer(x_bad.to_bytes(32, "big"), np.uint8)
        status[i] = ec.ERR_INVALID_PUBLIC_KEY
    for i, k in ((3, 0), (4, hc.N), (5, 2**256 - 1)):
        priv[i] = np.frombuffer(k.to_bytes(32, "big"), np.uint8)
        status[i] = ec.ERR_INVALID_SCALAR
    shared = np.zeros((lanes, 32), np.uint8)
    for i in np.nonzero(status == ec.OK)[0]:
        x = hc.mul(ks[i], peers[i])[0]
        shared[i] = np.frombuffer(x.to_bytes(32, "big"), np.uint8)
    return priv, pubs, shared, status


def test_ecdh_batch_arrays_statuses_on_corrupted_lanes():
    _, _, want_shared, want_status = _corrupted_batch()
    _, (shared, status) = _default_engine_run()
    assert status.tolist() == want_status.tolist()
    assert np.array_equal(shared, want_shared)
    assert not shared[want_status != ec.OK].any()


@pytest.mark.parametrize("engine", ["mega_unsigned", "not_mega"])
def test_glv_engines_give_the_same_bytes(engine):
    priv, pubs, want_shared, want_status = _corrupted_batch()
    _, default = _default_engine_run()
    try:
        if engine == "mega_unsigned":
            K.set_mega_signed(False)
        else:
            K.set_mega(False)
        K.reset_counts()
        shared, status = ecdh.ecdh_batch_arrays(priv, pubs, device="cpu")
        calls = dict(K.PLAIN_CALLS)
    finally:
        K.set_mega(True)
        K.set_mega_signed(True)
    assert calls["glv_windowed_mult_signed_from_points"] == 0
    if engine == "mega_unsigned":
        assert calls["glv_windowed_mult_from_points"] == 1
    else:
        assert calls["point_lookup_add"] == 64
        assert calls["point_double4"] == 32
    assert np.array_equal(shared, default[0])
    assert np.array_equal(status, default[1])
    assert np.array_equal(shared, want_shared)
    assert status.tolist() == want_status.tolist()
    assert K.mega_enabled() and K.mega_signed_enabled()


def test_private_key_ecdh_matches_ecdh_batch():
    rng = np.random.default_rng(7)
    privs = [keys.PrivateKey(int.from_bytes(rng.bytes(32), "big")
                             % (hc.N - 1) + 1) for _ in range(4)]
    privs.append(keys.PrivateKey(hc.N - 1))
    peers = privs[1:] + privs[:1]
    got = ecdh.ecdh_batch(privs, [p.public_key for p in peers],
                          device="cpu")
    assert got == [hc.mul(a.scalar, b.public_key.point)[0].to_bytes(32, "big")
                   for a, b in zip(privs, peers)]
    # The one-pair method is a batch of one; shared secrets are symmetric.
    assert privs[1].ecdh(privs[0].public_key, device="cpu") == got[0]
    assert len(got[0]) == 32
