"""The port's native host library against Python references.

`secp256k1_tpu_torch.native` (its own copy of the C++ host runtime, built by
g++ at first use under `build/`) against `hashlib`, the JAX package's
pure-Python strict-DER parser and RFC 6979 DRBG (including the three-read
state vectors), and the BIP-0340 tagged hash.  Every comparison is exact.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from secp256k1_tpu.models import codecs as jcodecs
from secp256k1_tpu.models.rfc6979 import DrbgRFC6979 as JaxDrbg
from secp256k1_tpu.models.schnorr import tagged_hash as jax_tagged_hash
from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import schnorr
from secp256k1_tpu_torch.models.rfc6979 import DrbgRFC6979

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "testdata")


def _sha(b):
    return hashlib.sha256(b).digest()


def test_library_lands_under_build():
    native.lib()
    path = native.library_path()
    assert os.path.exists(path)
    assert path.startswith(os.path.join(REPO, "build", "secp256k1_tpu_torch",
                                        "native") + os.sep)
    for pkg in ("secp256k1_tpu", "secp256k1_tpu_torch"):
        assert not path.startswith(os.path.join(REPO, pkg) + os.sep)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 100])
def test_sha256_batch(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (5, length), dtype=np.uint8)
    got = native.sha256_batch(msgs)
    for i in range(5):
        assert got[i].tobytes() == _sha(msgs[i].tobytes())


def test_rfc6979_batch_and_continuation_match_the_drbg():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    digs = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    first, sv, sk = native.rfc6979_nonce_batch(keys, digs)
    for i in range(6):
        ref = JaxDrbg(keys[i].tobytes(), digs[i].tobytes())
        port = DrbgRFC6979(keys[i].tobytes(), digs[i].tobytes())
        want = ref.read(32)
        assert first[i].tobytes() == want == port.read(32)
        for _ in range(2):
            want = ref.read(32)
            assert native.rfc6979_continue(sv, sk, i).tobytes() == want
            assert port.read(32) == want


def test_rfc6979_state_kat():
    """Three successive reads of one DRBG: the known-good state-update
    vectors that tests/test_ecdsa.py holds the JAX DRBG to, through the
    batch call and two continuations."""
    x = _sha(b"It's a proprietary strategy. I can't go into it in great "
             b"detail.")
    e = int.from_bytes(_sha(b"This is Fail(TM). But it's not Epic(TM) "
                            b"yet..."), "big") % schnorr.N
    expected = [
        "98b1853bf3b2798395bffd1ac98f8abaf3e0e3666268f70541890f5c884111cd",
        "6f52ef0ec8d7e821316fca6780a791df875b03c73405bf4f63321c07c98ace6e",
        "bf6133b75a1a9220e989ad9b765f859a8502257ac5b8d3914329374034f03ce0",
    ]
    keys = np.frombuffer(x, np.uint8).reshape(1, 32)
    digs = np.frombuffer(e.to_bytes(32, "big"), np.uint8).reshape(1, 32)
    first, sv, sk = native.rfc6979_nonce_batch(keys, digs)
    got = [first[0].tobytes().hex()] + [
        native.rfc6979_continue(sv, sk, 0).tobytes().hex() for _ in range(2)]
    assert got == expected
    port = DrbgRFC6979(x, e.to_bytes(32, "big"))
    assert [port.read(32).hex() for _ in range(3)] == expected
    with pytest.raises(ValueError):
        port.read(5)


def test_tagged_hash_batch():
    rng = np.random.default_rng(6)
    p1 = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    p2 = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    p3 = rng.integers(0, 256, (5, 17), dtype=np.uint8)
    for tag, parts in (("BIP0340/aux", (p1,)),
                       ("BIP0340/nonce", (p1, p2, p3)),
                       ("BIP0340/challenge", (p1, p2, p3))):
        args = list(parts) + [None] * (3 - len(parts))
        got = native.tagged_hash_batch(tag.encode(), *args, 5)
        for i in range(5):
            vals = [p[i].tobytes() for p in parts]
            assert got[i].tobytes() == jax_tagged_hash(tag, *vals) \
                == schnorr.tagged_hash(tag, *vals)


def _der_rows():
    sigs = []
    for fname in ("ecdsa_secp256k1_sha256_test.json",
                  "ecdsa_secp256k1_sha512_test.json"):
        with open(os.path.join(TESTDATA, "wycheproof", fname)) as f:
            data = json.load(f)
        for group in data["testGroups"]:
            sigs += [bytes.fromhex(t["sig"]) for t in group["tests"]]
    good = sigs[0]
    rng = np.random.default_rng(7)
    sigs += [good[:k] for k in range(len(good))]                 # truncated
    sigs += [bytes(rng.integers(0, 256, k, dtype=np.uint8))      # garbage
             for k in (1, 8, 40, 70, 72, 80)]
    sigs += [b"\x30\x00", b"\x30\x80\x02\x01\x01\x02\x01\x01", bytes(80),
             b"\x30\x06\x02\x01\x01\x02\x01\x01\xff", good + b"\x00"]
    return sigs


def test_asn1_parse_batch_matches_the_python_parser():
    """Status 0/1/2 and (r, s) equal the JAX package's pure-Python parser
    (and the port's copy of it) on every Wycheproof ECDSA DER row and on
    truncated and garbage rows."""
    sigs = _der_rows()
    max_len = max(len(s) for s in sigs)
    arr = np.zeros((len(sigs), max_len), dtype=np.uint8)
    lens = np.zeros((len(sigs),), dtype=np.int32)
    for i, s in enumerate(sigs):
        arr[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    r_arr, s_arr, status = native.asn1_sig_parse_batch(arr, lens)
    from secp256k1_tpu_torch.models import codecs
    seen = set()
    for i, sig in enumerate(sigs):
        try:
            want = (0,) + jcodecs.parse_asn1_signature(sig)
        except jcodecs.ScalarError:
            want = (2,)
        except jcodecs.CodecError:
            want = (1,)
        try:
            port = (0,) + codecs.parse_asn1_signature(sig)
        except codecs.ScalarError:
            port = (2,)
        except codecs.CodecError:
            port = (1,)
        got = (int(status[i]),)
        if got[0] == 0:
            got += (int.from_bytes(r_arr[i].tobytes(), "big"),
                    int.from_bytes(s_arr[i].tobytes(), "big"))
        assert got == want == port, (i, sig.hex())
        seen.add(got[0])
    assert seen == {0, 1, 2}
