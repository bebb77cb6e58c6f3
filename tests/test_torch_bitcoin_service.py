"""The port's Bitcoin consensus verify and verify service on the CPU.

- BIP-0066: the vector file through the port's validator, and the numpy
  form against the JAX package's numpy form and its scalar validator on
  the vectors and seeded mutations (numpy only);
- consensus verify: the cases of the JAX package's own test (a sighash
  byte, a missing one, high s), and the batch forms' statuses;
- `VerifyService` on `device="cpu"`: aggregation, backpressure, the keyed
  fast path against the unkeyed one, and a failing batch resolving every
  future with its exception.

Every future is awaited with a timeout and every service closed.
"""

import hashlib
import json
import os
import queue
import threading
import time

import numpy as np
import pytest
import torch

from secp256k1_tpu.models import bitcoin as jbitcoin
from secp256k1_tpu_torch.models import bitcoin, codecs, ecdsa, keys, service
from secp256k1_tpu_torch.models.rfc6979 import RFC6979SHA256
from secp256k1_tpu_torch.utils import errors as ec

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
N = keys.N
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


@pytest.fixture(autouse=True)
def _inference_mode():
    """No autograd bookkeeping: the plain path dispatches many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def signed():
    """Three keys, nine digests and their low-s DER signatures."""
    privs = [keys.PrivateKey(51 + i) for i in range(3)]
    digests = [hashlib.sha256(bytes([i]) * 5).digest() for i in range(9)]
    with torch.inference_mode():
        sigs = ecdsa.sign_batch([privs[i % 3] for i in range(9)], digests,
                                rand=RFC6979SHA256(), device=CPU)
    return privs, digests, sigs


def _vectors():
    with open(os.path.join(TESTDATA, "bip-0066-test-vectors.json")) as f:
        data = json.load(f)
    valid = [bytes.fromhex(c["DER"]) + b"\x45" for c in data["valid"]]
    invalid = [bytes.fromhex(c["DER"]) + b"\x45"
               for c in data["invalid"]["decode"]]
    return valid, invalid


def _rows(sigs, width=80):
    arr = np.zeros((len(sigs), width), np.uint8)
    for i, s in enumerate(sigs):
        arr[i, :len(s)] = np.frombuffer(s, np.uint8)
    return arr, np.asarray([len(s) for s in sigs], np.int32)


# --- BIP-0066 ------------------------------------------------------------

def test_bip0066_vectors():
    valid, invalid = _vectors()
    assert all(bitcoin.is_valid_signature_encoding_bip0066(s) for s in valid)
    assert not any(bitcoin.is_valid_signature_encoding_bip0066(s)
                   for s in invalid)


def test_bip0066_np_matches_jax_on_vectors_and_mutations():
    """The numpy form against the JAX numpy form and both scalar forms:
    the vectors, then seeded mutations of them (a byte changed, a byte cut
    or added, a length byte off by one)."""
    valid, invalid = _vectors()
    rng = np.random.default_rng(66)
    cases = list(valid) + list(invalid)
    for _ in range(600):
        s = bytearray(valid[rng.integers(len(valid))])
        kind = rng.integers(4)
        if kind == 0:
            s[rng.integers(len(s))] = int(rng.integers(256))
        elif kind == 1:
            del s[rng.integers(len(s))]
        elif kind == 2:
            s.insert(int(rng.integers(len(s) + 1)), int(rng.integers(256)))
        else:
            pos = int(rng.choice([1, 3, 5 + s[3]])) if 5 + s[3] < len(s) \
                else 1
            s[pos] = (s[pos] + int(rng.choice([-1, 1]))) % 256
        cases.append(bytes(s))
    cases += [b"", b"\x30", bytes(73), b"\x30" * 74]
    arr, lens = _rows(cases)
    got = bitcoin.bip0066_valid_np(arr, lens)
    assert np.array_equal(got, jbitcoin.bip0066_valid_np(arr, lens))
    scalar = [bitcoin.is_valid_signature_encoding_bip0066(s) for s in cases]
    assert got.tolist() == scalar
    assert scalar == [jbitcoin.is_valid_signature_encoding_bip0066(s)
                      for s in cases]
    assert 0 < sum(scalar) < len(cases)


# --- consensus verify ----------------------------------------------------

def test_consensus_verify(signed):
    """A sighash byte passes; without it the DER fails BIP-0066's length
    accounting; high s is rejected."""
    privs, digests, sigs = signed
    pub, digest, sig = privs[0].public_key, digests[0], sigs[0]
    assert bitcoin.verify_asn1(pub, digest, sig + b"\x01", device=CPU)
    assert not bitcoin.verify_asn1(pub, digest, sig, device=CPU)
    r, s = codecs.parse_asn1_signature(sig)
    high = codecs.build_asn1_signature(r, N - s) + b"\x01"
    assert not bitcoin.verify_asn1(pub, digest, high, device=CPU)


def test_consensus_batches(signed):
    """verify_asn1_batch_arrays statuses and verify_asn1_batch bools on
    valid lanes, high s, a missing sighash byte, a BIP-0066 vector that
    fails and a wrong digest."""
    privs, digests, sigs = signed
    _, invalid = _vectors()
    pubs = [privs[i % 3].public_key for i in range(8)]
    digs = list(digests[:8])
    full = [s + b"\x01" for s in sigs[:8]]
    want = [ec.OK] * 8
    r, s = codecs.parse_asn1_signature(sigs[1])
    full[1] = codecs.build_asn1_signature(r, N - s) + b"\x01"
    want[1] = ec.ERR_MALLEABLE
    full[2] = sigs[2]
    want[2] = ec.ERR_INVALID_ENCODING
    full[3] = invalid[2]
    want[3] = ec.ERR_INVALID_ENCODING
    digs[4] = digests[8]
    want[4] = ec.ERR_V_NEQ_R
    arr, lens = _rows(full)
    pub_arr = np.stack([np.frombuffer(p.compressed_bytes(), np.uint8)
                        for p in pubs])
    dig_arr = np.stack([np.frombuffer(d, np.uint8) for d in digs])
    st = bitcoin.verify_asn1_batch_arrays(pub_arr, dig_arr, arr, lens,
                                          device=CPU)
    assert st.tolist() == want
    assert bitcoin.verify_asn1_batch(pubs, digs, full, device=CPU) == \
        [w == ec.OK for w in want]


# --- the verify service --------------------------------------------------

def test_service_aggregates_requests(signed):
    """Nine requests, max_lanes=4: at most three batches."""
    privs, digests, sigs = signed
    svc = service.VerifyService(max_lanes=4, max_wait_s=0.05, device=CPU)
    try:
        futs = [svc.submit(privs[i % 3].public_key, digests[i], sigs[i])
                for i in range(9)]
        svc.flush()
        assert all(f.result(timeout=30) for f in futs)
        assert svc.verified == 9 and svc.batches <= 3
    finally:
        svc.close()
    assert not svc._worker.is_alive()


def test_service_backpressure(signed, monkeypatch):
    """The verify call stalled on an event: with max_pending=1 the worker
    holds one request and the queue one more, so a third submit times out
    with queue.Full.  The stalled call then answers OK without the device
    (the other tests hold the answers)."""
    privs, digests, sigs = signed
    release = threading.Event()

    def stalled_arrays(pubs, *args, **kwargs):
        release.wait(timeout=30)
        return np.zeros((pubs.shape[0],), np.int32)

    def stalled_list(pubs, *args, **kwargs):
        release.wait(timeout=30)
        return [True] * len(pubs)
    # The service's fast path calls verify_batch_arrays, its other path
    # verify_batch: stall both.
    monkeypatch.setattr(service.ecdsamod, "verify_batch_arrays",
                        stalled_arrays)
    monkeypatch.setattr(service.ecdsamod, "verify_batch", stalled_list)
    svc = service.VerifyService(max_lanes=1, max_wait_s=0.01, max_pending=1,
                                device=CPU)
    try:
        f1 = svc.submit(privs[0].public_key, digests[0], sigs[0])
        time.sleep(0.2)                  # the worker took f1 and stalled
        f2 = svc.submit(privs[1].public_key, digests[1], sigs[1])
        with pytest.raises(queue.Full):
            svc.submit(privs[2].public_key, digests[2], sigs[2],
                       timeout=0.05)
        release.set()
        assert f1.result(timeout=30) and f2.result(timeout=30)
    finally:
        release.set()
        svc.close()


def test_service_keyed_path_matches_unkeyed(signed):
    """key_cache_capacity: the keyed path gives the unkeyed path's bools,
    a wrong digest among them, over a deduplicated signer set."""
    privs, digests, sigs = signed
    reqs = [(privs[i % 3].public_key, digests[i], sigs[i]) for i in range(9)]
    reqs.append((privs[0].public_key, digests[1], sigs[0]))
    results = []
    for capacity in (4, 0):
        svc = service.VerifyService(max_lanes=16, max_wait_s=0.05,
                                    key_cache_capacity=capacity, device=CPU)
        try:
            futs = [svc.submit(*r) for r in reqs]
            svc.flush()
            results.append([f.result(timeout=30) for f in futs])
            if capacity:
                assert len(svc._keys.points) == 3
                assert svc._keys.cache.n_keys == 4
        finally:
            svc.close()
    assert results[0] == results[1] == [True] * 9 + [False]


def test_service_failing_batch_resolves_every_future(signed, monkeypatch):
    """A batch whose verify raises resolves each of its futures with that
    exception."""
    privs, digests, sigs = signed
    boom = RuntimeError("device lost")

    def failing(*args, **kwargs):
        raise boom
    monkeypatch.setattr(service.ecdsamod, "verify_batch_arrays", failing)
    svc = service.VerifyService(max_lanes=8, max_wait_s=0.05, device=CPU)
    try:
        futs = [svc.submit(privs[i % 3].public_key, digests[i], sigs[i])
                for i in range(5)]
        svc.flush()
        for f in futs:
            assert f.exception(timeout=30) is boom
        assert svc.batches == 0 and svc.verified == 0
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(privs[0].public_key, digests[0], sigs[0])
