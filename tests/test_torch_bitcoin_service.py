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
import queue
import threading
import time

import numpy as np
import pytest
import torch

import bip0066_cases
from secp256k1_tpu.models import bitcoin as jbitcoin
from secp256k1_tpu_torch.models import bitcoin, codecs, ecdsa, keys, service
from secp256k1_tpu_torch.models.rfc6979 import RFC6979SHA256
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
N = keys.N


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


def _rows(sigs, width=80):
    arr = np.zeros((len(sigs), width), np.uint8)
    for i, s in enumerate(sigs):
        arr[i, :len(s)] = np.frombuffer(s, np.uint8)
    return arr, np.asarray([len(s) for s in sigs], np.int32)


# --- BIP-0066 ------------------------------------------------------------

def test_bip0066_vectors():
    valid, invalid = bip0066_cases.vectors()
    assert all(bitcoin.is_valid_signature_encoding_bip0066(s) for s in valid)
    assert not any(bitcoin.is_valid_signature_encoding_bip0066(s)
                   for s in invalid)


def test_bip0066_np_matches_jax_on_vectors_and_mutations():
    """The numpy form against the JAX numpy form and both scalar forms:
    the vectors, then seeded mutations of them (a byte changed, a byte cut
    or added, a length byte off by one)."""
    cases = bip0066_cases.cases()
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
    _, invalid = bip0066_cases.vectors()
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


def test_consensus_statuses_equal_the_numpy_composition(signed):
    """verify_asn1_batch_arrays, whose native pass checks BIP-0066 while it
    parses, gives the statuses of the composition it replaced lane for
    lane: the NumPy BIP-0066 check, a placeholder row where it fails,
    `ecdsa.verify_batch_arrays(reject_malleable=True)`, then
    ERR_INVALID_ENCODING ahead of every other status."""
    privs, digests, sigs = signed
    n = 13
    pubs = [privs[i % 3].public_key.compressed_bytes() for i in range(n)]
    digs = [digests[i % 9] for i in range(n)]
    rows = [sigs[i % 9] + b"\x01" for i in range(n)]
    want = [ec.OK] * n
    r, s = codecs.parse_asn1_signature(sigs[1])
    rows[1] = codecs.build_asn1_signature(r, N - s) + b"\x01"
    want[1] = ec.ERR_MALLEABLE
    rows[2] = sigs[2]                                    # no sighash byte
    row = rows[3]
    rows[3] = b"\x31" + row[1:]                          # not a SEQUENCE
    row = rows[4]
    rows[4] = (bytes([0x30, row[1] + 1, 0x02, row[3] + 1, 0x00])
               + row[4:])                                # r with a 0x00
    row = rows[5]
    rows[5] = row[:1] + bytes([row[1] + 1]) + row[2:]    # a wrong length
    for i in (2, 3, 4, 5):
        want[i] = ec.ERR_INVALID_ENCODING
    digs[6] = digests[8] if digs[6] != digests[8] else digests[0]
    want[6] = ec.ERR_V_NEQ_R
    x = 5
    while hc.lift_x(x, False) is not None:
        x += 1
    pubs[7] = b"\x02" + x.to_bytes(32, "big")
    want[7] = ec.ERR_INVALID_PUBLIC_KEY
    pubs[8] = b"\x05" + pubs[8][1:]                      # bad prefix and
    rows[8] = rows[8][:-1]                               # no sighash byte
    want[8] = ec.ERR_INVALID_ENCODING
    pubs[9] = b"\x05" + pubs[9][1:]
    want[9] = ec.ERR_INVALID_PUBLIC_KEY
    rows[10] = bytes.fromhex("3006020100020101") + b"\x01"   # r = 0
    want[10] = ec.ERR_INVALID_SCALAR
    arr, lens = _rows(rows)
    pub_arr = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
    dig_arr = np.stack([np.frombuffer(d, np.uint8) for d in digs])
    got = bitcoin.verify_asn1_batch_arrays(pub_arr, dig_arr, arr, lens,
                                           device=CPU)

    enc_ok = bitcoin.bip0066_valid_np(arr, lens)
    old_lens = np.where(enc_ok, lens - 1, 2).astype(np.int32)
    old_sigs = arr.copy()
    old_sigs[~enc_ok, :2] = (0x30, 0x00)
    st = ecdsa.verify_batch_arrays(pub_arr, dig_arr, old_sigs, old_lens,
                                   reject_malleable=True, device=CPU)
    old = np.where(enc_ok, st, ec.ERR_INVALID_ENCODING).astype(np.int32)
    assert got.dtype == np.int32
    assert got.tolist() == old.tolist() == want


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
