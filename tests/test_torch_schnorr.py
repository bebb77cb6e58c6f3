"""The port's BIP-0340 slice on the CPU: every row of
`tests/testdata/bip-0340-test-vectors.csv` through the list and the arrays
paths, signatures byte-exact and verify results exact, and the challenge
hash's wrapper (`K.bip340_challenge`) against hashlib.

The arrays paths take one message length a batch, so the rows go in one
batch per message length (32 bytes, then 0, 1, 17 and 100).

On a card (marked `card`, skipped without one): the challenge kernel
`k_bip340_challenge` against the native library's tagged hash at 16,384
and 65,536 lanes and every length of `CHALLENGE_LENGTHS`, and the vectors
through `verify_batch_arrays` there, every lane's challenge hashed by the
kernel (one launch, the `schnorr.core` span's lanes).  Run there with `python -m pytest
--noconftest -p no:cacheprovider -m card tests/test_torch_schnorr.py`: the
JAX package, which two CPU cases compare with, is imported inside them.
"""

import csv
import os
import time

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import keys, schnorr
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import profiling

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
# Message lengths of the challenge hash: 55 bytes are the most whose
# padding fits the block after R.x || P.x, 56 the fewest that spill into
# another.
CHALLENGE_LENGTHS = [0, 1, 32, 55, 56, 64, 100]


def _rows():
    with open(os.path.join(TESTDATA, "bip-0340-test-vectors.csv")) as f:
        return list(csv.DictReader(f))


ROWS = _rows()
SIGNED = [r for r in ROWS if r["secret key"]]
MSG_LENS = sorted({len(r["message"]) // 2 for r in ROWS})


def _b(hexstr):
    return bytes.fromhex(hexstr)


def _arr(rows, field, width):
    return np.stack([np.frombuffer(_b(r[field]), np.uint8)
                     for r in rows]).reshape(len(rows), width)


class _AuxQueue:
    """Hands out each lane's aux_rand in lane order."""

    def __init__(self, auxes):
        self.auxes = list(auxes)

    def read(self, n):
        aux = self.auxes.pop(0)
        assert n == len(aux)
        return aux


def test_vectors_cover_every_length_and_both_results():
    assert len(ROWS) == 19 and len(SIGNED) == 8
    assert MSG_LENS == [0, 1, 17, 32, 100]
    assert {r["verification result"] for r in ROWS} == {"TRUE", "FALSE"}


def test_sign_batch_list():
    privs = [schnorr.SchnorrPrivateKey.from_bytes(_b(r["secret key"]))
             for r in SIGNED]
    for priv, r in zip(privs, SIGNED):
        assert priv.public_key.bytes().hex().upper() == r["public key"]
    sigs = schnorr.sign_batch(privs, [_b(r["message"]) for r in SIGNED],
                              rand=_AuxQueue([_b(r["aux_rand"])
                                              for r in SIGNED]), device=CPU)
    assert [s.hex().upper() for s in sigs] == [r["signature"]
                                               for r in SIGNED]


def test_verify_batch_list():
    from secp256k1_tpu.models import schnorr as jschnorr
    pubs, msgs, sigs, want = [], [], [], []
    for r in ROWS:
        try:
            pub = schnorr.SchnorrPublicKey.from_bytes(_b(r["public key"]))
        except ValueError:
            assert r["verification result"] == "FALSE", r["index"]
            with pytest.raises(ValueError):
                jschnorr.SchnorrPublicKey.from_bytes(_b(r["public key"]))
            continue
        pubs.append(pub)
        msgs.append(_b(r["message"]))
        sigs.append(_b(r["signature"]))
        want.append(r["verification result"] == "TRUE")
    sigs.append(sigs[0][:-1])                     # wrong length
    pubs.append(pubs[0])
    msgs.append(msgs[0])
    want.append(False)
    assert schnorr.verify_batch(pubs, msgs, sigs, device=CPU) == want


@pytest.mark.parametrize("msg_len", MSG_LENS)
def test_sign_batch_arrays(msg_len):
    """The vectors of one message length in one batch.  The 32-byte batch
    also holds keys 0 and n, which fail with ERR_INVALID_SCALAR and zeroed
    signatures while the other lanes still sign."""
    rows = [r for r in SIGNED if len(r["message"]) == 2 * msg_len]
    priv = _arr(rows, "secret key", 32)
    msgs = _arr(rows, "message", msg_len)
    aux = _arr(rows, "aux_rand", 32)
    want = [ec.OK] * len(rows)
    if msg_len == 32:
        bad = np.stack([np.zeros(32, np.uint8), np.frombuffer(
            schnorr.N.to_bytes(32, "big"), np.uint8)])
        priv = np.concatenate([priv, bad])
        msgs = np.concatenate([msgs, msgs[:2]])
        aux = np.concatenate([aux, aux[:2]])
        want += [ec.ERR_INVALID_SCALAR] * 2
    sigs, status = schnorr.sign_batch_arrays(priv, msgs, aux, device=CPU)
    assert status.tolist() == want
    assert [s.tobytes().hex().upper() for s in sigs[:len(rows)]] == \
        [r["signature"] for r in rows]
    assert not sigs[len(rows):].any()


def _verify_vectors(msg_len, device):
    """The vectors of one message length through `verify_batch_arrays`
    under a profiler session: their results exact, and every lane's
    challenge hashed in one call, by the kernel on a card (its launch, the
    core's device time) and by the plain version on the CPU, in one
    `schnorr.core` span of all the lanes."""
    rows = [r for r in ROWS if len(r["message"]) == 2 * msg_len]
    on_card = torch.device(device).type == "cuda"
    calls = K.LAUNCHES if on_card else K.PLAIN_CALLS
    before = calls["bip340_challenge"]
    t0 = time.perf_counter()
    with torch.profiler.profile():
        got = schnorr.verify_batch_arrays(
            _arr(rows, "public key", 32), _arr(rows, "message", msg_len),
            _arr(rows, "signature", 64), device=device)
    assert got.dtype == bool
    assert got.tolist() == [r["verification result"] == "TRUE"
                            for r in rows]
    assert calls["bip340_challenge"] == before + 1
    cores = [r for r in profiling.spans()
             if r.name == "schnorr.core" and r.t0 >= t0]
    assert [(r.lanes, r.device_ms is not None) for r in cores] == \
        [(len(rows), on_card)]


@pytest.mark.parametrize("msg_len", MSG_LENS)
def test_verify_batch_arrays(msg_len):
    _verify_vectors(msg_len, CPU)


def _challenge_rows(lanes, length):
    rng = np.random.default_rng(lanes + length)
    return [rng.integers(0, 256, (lanes, w), dtype=np.uint8)
            for w in (32, 32, length)]


@pytest.mark.parametrize("length", CHALLENGE_LENGTHS)
def test_challenge_wrapper_on_the_cpu_is_hashlib(length):
    """`K.bip340_challenge` on CPU planes (its plain version): each lane's
    SHA256(t || t || r || px || m), as a [32, B] plane."""
    rows = _challenge_rows(20, length)
    planes = [bt.byte_plane_np(a, 32, CPU) for a in rows]
    plain = K.PLAIN_CALLS["bip340_challenge"]
    got = K.bip340_challenge(*planes)
    assert K.PLAIN_CALLS["bip340_challenge"] == plain + 1
    assert got.dtype == torch.uint8 and tuple(got.shape) == (32, 32)
    for i in range(20):
        assert got[:, i].numpy().tobytes() == schnorr.tagged_hash(
            schnorr.TAG_CHALLENGE, *(a[i].tobytes() for a in rows))
    with pytest.raises(ValueError):
        K.bip340_challenge(planes[0], planes[1][:31].contiguous(), planes[2])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("lanes", [16384, 65536])
@pytest.mark.parametrize("length", CHALLENGE_LENGTHS)
def test_card_challenge_kernel_equals_native(card, lanes, length):
    """One `k_bip340_challenge` launch, every lane equal to the native
    library's tagged hash of the same rows."""
    rows = _challenge_rows(lanes, length)
    planes = [bt.byte_plane_np(a, lanes, card) for a in rows]
    launches = K.LAUNCHES["bip340_challenge"]
    got = K.bip340_challenge(*planes)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bip340_challenge"] == launches + 1
    want = native.tagged_hash_batch(K.BIP340_CHALLENGE_TAG, *rows, lanes)
    assert np.array_equal(got.cpu().numpy().T, want)


@pytest.mark.card
@pytest.mark.parametrize("msg_len", MSG_LENS)
def test_card_verify_batch_arrays(card, msg_len):
    _verify_vectors(msg_len, card)


def test_keys_and_tagged_hashes():
    from secp256k1_tpu.models import schnorr as jschnorr
    e = keys.PrivateKey(0x1234)
    sp = schnorr.SchnorrPrivateKey.from_ecdsa(e)
    assert sp.public_key == schnorr.SchnorrPublicKey.from_ecdsa(e.public_key)
    assert sp.public_key.bytes() == jschnorr.SchnorrPrivateKey(
        0x1234).public_key.bytes()
    assert schnorr.pre_hash_message("test/domain", b"msg") == \
        jschnorr.pre_hash_message("test/domain", b"msg")
    with pytest.raises(ValueError):
        schnorr.pre_hash_message("", b"msg")
    with pytest.raises(ValueError):
        schnorr.SchnorrPrivateKey(0)
