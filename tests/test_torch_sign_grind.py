"""Bitcoin Core's wallet signer on the port, on the CPU: RFC 6979 with
additional data, low-R grinding, low s and strict DER with the sighash
byte (`bitcoin.sign_der_batch_arrays`), held byte for byte to the plain
reference `tests/wallet_sign_ref.py`.

- the native DRBG with and without additional data, row for row;
- the RFC 6979 vectors, where their r is low, through the grinding signer;
- 64 seeded lanes, one of them needing 4 attempts or more, ground and not;
- every output parsed under BIP-0066, low R, low s, at most 71 bytes and
  verified by the port's consensus verify and by the reference;
- keys not in [1, n), and the call's counters;
- the nonces derived by the sign core's DRBG wrapper, never by the native
  DRBG.
"""

import csv
import hashlib
import os

import numpy as np
import pytest
import torch

import wallet_sign_ref as ref
from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import bitcoin
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import errors as ec

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
N = ref.N
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
LANES = 64
# A seed whose 64 lanes include one of 4 attempts or more (checked below).
SEED = 2026_1016


def _rows(vals) -> np.ndarray:
    return np.stack([np.frombuffer(v.to_bytes(32, "big"), np.uint8)
                     for v in vals])


def _keys_digests(seed: int, lanes: int):
    gen = np.random.default_rng(seed)
    keys = [1 + int.from_bytes(gen.bytes(40), "big") % (N - 1)
            for _ in range(lanes)]
    digests = gen.integers(0, 256, (lanes, 32), dtype=np.uint8)
    digests[3] = 0xFF                    # a digest above n: e = digest - n
    return keys, digests


def _ref_rows(keys, digests, sighash=ref.SIGHASH_ALL, grind=True):
    return [ref.core_sign(d, row.tobytes(), sighash, grind)
            for d, row in zip(keys, digests)]


def _assert_equal(got, want):
    der, lens, status = got
    assert der.shape == (len(want), 72) and der.dtype == np.uint8
    assert lens.dtype == np.int32 and status.dtype == np.int32
    assert status.tolist() == [ec.OK] * len(want)
    assert lens.tolist() == [len(w[0]) for w in want]
    for i, w in enumerate(want):
        assert der[i, :lens[i]].tobytes() == w[0], i
        assert not der[i, lens[i]:].any()


@pytest.fixture(scope="module")
def lanes():
    keys, digests = _keys_digests(SEED, LANES)
    stats = bitcoin.SignStats()
    ground = bitcoin.sign_der_batch_arrays(_rows(keys), digests, device=CPU,
                                           stats=stats)
    return {"keys": keys, "digests": digests, "ground": ground,
            "stats": stats, "want": _ref_rows(keys, digests)}


# ---------------------------------------------------------------------------
# The DRBG with additional data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", ["none", "random", "grind"])
def test_rfc6979_batch_with_extra_matches_the_reference(extra):
    keys, digests = _keys_digests(SEED + 1, 32)
    e_rows = _rows([int.from_bytes(r.tobytes(), "big") % N for r in digests])
    if extra == "none":
        rows = None
    elif extra == "random":
        rows = np.random.default_rng(7).integers(0, 256, (32, 32),
                                                 dtype=np.uint8)
    else:
        rows = np.stack([np.frombuffer(ref.grind_extra(c + 1), np.uint8)
                         for c in range(32)])
    k, sv, sk = native.rfc6979_nonce_batch(_rows(keys), e_rows, rows)
    for i, d in enumerate(keys):
        args = (d.to_bytes(32, "big"), digests[i].tobytes(),
                None if rows is None else rows[i].tobytes())
        assert k[i].tobytes() == ref.nonce_rfc6979(*args), i
        assert native.rfc6979_continue(sv, sk, i).tobytes() == \
            ref.nonce_rfc6979(*args, counter=1), i
    if rows is not None:
        plain = native.rfc6979_nonce_batch(_rows(keys), e_rows)[0]
        assert not (plain == k).all(axis=1).any()


# ---------------------------------------------------------------------------
# The RFC 6979 vectors.
# ---------------------------------------------------------------------------

def test_rfc6979_vectors_through_the_grinding_signer():
    """Where a vector's r is below 2^255, round 0 is its signature; where
    it is not, grinding signs again and the reference agrees."""
    with open(os.path.join(TESTDATA, "secp256k1_rfc6979_sha256.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    keys = [int(r[0]) for r in rows]
    digests = np.stack([np.frombuffer(hashlib.sha256(r[1].encode()).digest(),
                                      np.uint8) for r in rows])
    kat = [bytes.fromhex(r[2]) for r in rows]
    low = [k[4] != 0 for k in kat]          # no pad byte in front of r
    assert 0 < sum(low) < len(rows)
    for grind in (True, False):
        der, lens, status = bitcoin.sign_der_batch_arrays(
            _rows(keys), digests, grind=grind, device=CPU)
        assert status.tolist() == [ec.OK] * len(rows)
        for i, want in enumerate(kat):
            got = der[i, :lens[i]].tobytes()
            assert got[-1] == ref.SIGHASH_ALL
            if low[i] or not grind:
                assert got[:-1] == want, i
            else:
                assert got[:-1] != want and got[3] <= 32, i
                assert got == ref.core_sign(keys[i], digests[i].tobytes())[0]


# ---------------------------------------------------------------------------
# Seeded lanes against the reference.
# ---------------------------------------------------------------------------

def test_ground_lanes_match_the_reference(lanes):
    attempts = [w[1] for w in lanes["want"]]
    assert max(attempts) >= 4
    _assert_equal(lanes["ground"], lanes["want"])
    assert lanes["stats"] == bitcoin.SignStats(max(attempts), sum(attempts),
                                               LANES)


def test_nonces_never_leave_the_sign_core(lanes, monkeypatch):
    """With the native DRBG refusing every call, the signer gives the same
    bytes: each round derives its nonces through the DRBG wrapper, once a
    round where no lane is resampled."""
    def refuse(*args, **kwargs):
        raise RuntimeError("the native DRBG was entered")
    monkeypatch.setattr(native, "rfc6979_nonce_batch", refuse)
    monkeypatch.setattr(native, "rfc6979_continue", refuse)
    keys, digests = lanes["keys"][:16], lanes["digests"][:16]
    K.reset_counts()
    stats = bitcoin.SignStats()
    got = bitcoin.sign_der_batch_arrays(_rows(keys), digests, device=CPU,
                                        stats=stats)
    _assert_equal(got, lanes["want"][:16])
    assert stats.rounds > 1
    assert K.PLAIN_CALLS["rfc6979_nonce"] == stats.rounds
    assert K.LAUNCHES["rfc6979_nonce"] == 0


@pytest.mark.parametrize("sighash", [ref.SIGHASH_ALL, 0x83])
def test_without_grinding_is_round_zero(lanes, sighash):
    keys, digests = lanes["keys"][:16], lanes["digests"][:16]
    stats = bitcoin.SignStats()
    got = bitcoin.sign_der_batch_arrays(_rows(keys), digests,
                                        sighash=sighash, grind=False,
                                        device=CPU, stats=stats)
    want = _ref_rows(keys, digests, sighash, grind=False)
    _assert_equal(got, want)
    assert stats == bitcoin.SignStats(1, 16, 16)
    assert any(got[0][i, 4] == 0 for i in range(16))    # a high r, padded


def test_outputs_are_consensus_signatures(lanes):
    der, lens, _ = lanes["ground"]
    r, s, st = native.bip0066_sig_parse_batch(der, lens)
    assert st.tolist() == [0] * LANES and lens.max() <= 71
    rs = [int.from_bytes(x.tobytes(), "big") for x in r]
    ss = [int.from_bytes(x.tobytes(), "big") for x in s]
    assert all(v < 2**255 for v in rs) and all(v <= N // 2 for v in ss)
    pubs = [ref.point_mul(d) for d in lanes["keys"]]
    sec1 = np.stack([np.frombuffer(bytes([2 | (q[1] & 1)])
                                   + q[0].to_bytes(32, "big"), np.uint8)
                     for q in pubs])
    st = bitcoin.verify_asn1_batch_arrays(sec1, lanes["digests"], der, lens,
                                          device=CPU)
    assert st.tolist() == [ec.OK] * LANES
    for q, row, a, b in zip(pubs, lanes["digests"], rs, ss):
        assert ref.verify(q, row.tobytes(), a, b)


def test_invalid_keys_get_err_invalid_scalar():
    keys = _rows([0, N, 2**256 - 1, 5])
    digests = np.full((4, 32), 9, np.uint8)
    der, lens, status = bitcoin.sign_der_batch_arrays(keys, digests,
                                                      device=CPU)
    assert status.tolist() == [ec.ERR_INVALID_SCALAR] * 3 + [ec.OK]
    assert lens[:3].tolist() == [0] * 3 and not der[:3].any()
    assert der[3, :lens[3]].tobytes() == \
        ref.core_sign(5, digests[3].tobytes())[0]
