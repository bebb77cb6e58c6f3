"""Taproot signature checks on the port, on the CPU:
`bitcoin.verify_taproot_batch_arrays` held to the plain reference
`tests/taproot_ref.py` (Bitcoin Core's `CheckSchnorrSignature` under
BIP-0341 and BIP-0342, in python ints) and to the status each case must
give.

One batch of 64 seeded valid lanes and one lane or more a case goes
through the port once (module fixture): every length 0, 32, 63, 64, 65,
66; every class of hash type; each corruption kind of the benchmark's
traffic; r = p, s = n, key x = p; Core's precedence where rules collide;
and BIP-0340's published vectors (those of 32-byte messages) as 64-byte
signatures.  Each case is a test of its own lanes.  Beside it,
`schnorr.verify_batch_arrays` against the status helper both share, and
the challenge lanes it counts (`schnorr.CHALLENGE_LANES`).

On a card (marked `card`, skipped without one): the same batch tiled to
16,384 lanes, a block of the benchmark's `verify.taproot`, through the
Schnorr core's replayed CUDA graph, every status the reference's and every
lane's challenge hashed by the kernel.  Run there with `python -m pytest
--noconftest -p no:cacheprovider -m card tests/test_torch_taproot.py`.
"""

import csv
import os

import numpy as np
import pytest
import torch

import taproot_ref as ref
from secp256k1_tpu_torch.models import bitcoin, schnorr
from secp256k1_tpu_torch.utils import errors as ec

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
N, P = ref.N, ref.P
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
SEEDED = 64
WIDTH = 66
SEED = 2026_1018
HASH_TYPES = [0x00, 0x01, 0x02, 0x03, 0x81, 0x82, 0x83, 0x04, 0x80, 0x84,
              0xFF]
LENGTHS = [0, 32, 63, 64, 65, 66]
KINDS = ["size", "hashtype", "key", "digest", "s"]
EDGES = ["r_eq_p", "s_eq_n", "key_x_eq_p"]
PRECEDENCE = ["size_over_hashtype", "size_over_bad_sig",
              "hashtype_over_bad_sig"]


def _vectors():
    with open(os.path.join(TESTDATA, "bip-0340-test-vectors.csv")) as f:
        return [r for r in csv.DictReader(f) if len(r["message"]) == 64]


VECTORS = _vectors()


def _b32(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _off_curve_x(gen) -> bytes:
    while True:
        x = int.from_bytes(gen.bytes(32), "big") % P
        if ref.lift_x(x) is None:
            return _b32(x)


class Lanes:
    """Rows built lane by lane, each case naming its lanes and the status
    it must give."""

    def __init__(self):
        self.pubs, self.digests, self.sigs, self.lens = [], [], [], []
        self.cases = {}
        self.logs = {}

    def add(self, case, pub, digest, sig, length, want):
        row = bytes(sig[:WIDTH]) + bytes(WIDTH - min(len(sig), WIDTH))
        self.cases.setdefault(case, []).append((len(self.pubs), want))
        self.pubs.append(pub)
        self.digests.append(digest)
        self.sigs.append(row)
        self.lens.append(length)

    def arrays(self):
        def rows(items, w):
            return np.frombuffer(b"".join(items), np.uint8).reshape(
                -1, w).copy()
        return (rows(self.pubs, 32), rows(self.digests, 32),
                rows(self.sigs, WIDTH), np.array(self.lens, np.int32))


def _signer(gen, lanes: Lanes):
    """A seeded key (even y), a digest and its BIP-0340 signature."""
    d = 1 + int.from_bytes(gen.bytes(40), "big") % (N - 1)
    k = 1 + int.from_bytes(gen.bytes(40), "big") % (N - 1)
    pt, big_r = ref.point_mul(d), ref.point_mul(k)
    d = d if pt[1] % 2 == 0 else N - d
    k = k if big_r[1] % 2 == 0 else N - k
    pub, rx = _b32(pt[0]), _b32(big_r[0])
    digest = gen.bytes(32)
    e = int.from_bytes(ref.tagged_hash("BIP0340/challenge",
                                       rx + pub + digest), "big") % N
    lanes.logs[pub] = d
    return pub, digest, rx + _b32((k + e * d) % N)


def _build() -> Lanes:
    gen = np.random.default_rng(SEED)
    lanes = Lanes()
    for _ in range(SEEDED):
        pub, dig, sig = _signer(gen, lanes)
        lanes.add("seeded", pub, dig, sig, 64, ref.OK)
    for n in LENGTHS:
        pub, dig, sig = _signer(gen, lanes)
        row = (sig + b"\x01\x02")[:n]
        want = ref.OK if n in (64, 65) else ref.SIG_SIZE
        lanes.add(f"len_{n}", pub, dig, row, n, want)
    for t in HASH_TYPES:
        pub, dig, sig = _signer(gen, lanes)
        want = ref.OK if t in ref.HASH_TYPES else ref.SIG_HASHTYPE
        lanes.add(f"hashtype_{t:02x}", pub, dig, sig + bytes([t]), 65, want)
    for kind in KINDS:
        pub, dig, sig = _signer(gen, lanes)
        length, want = 64, ref.SIG
        if kind == "size":
            length, want = 63, ref.SIG_SIZE
            sig = sig[:63]
        elif kind == "hashtype":
            length, want = 65, ref.SIG_HASHTYPE
            sig += b"\x80"
        elif kind == "key":
            pub = _off_curve_x(gen)
        elif kind == "digest":
            dig = bytes([dig[0] ^ 0x10]) + dig[1:]
        else:
            sig = sig[:32] + _b32(N + int.from_bytes(gen.bytes(16), "big"))
        lanes.add(f"kind_{kind}", pub, dig, sig, length, want)
    for edge in EDGES:
        pub, dig, sig = _signer(gen, lanes)
        if edge == "r_eq_p":
            sig = _b32(P) + sig[32:]
        elif edge == "s_eq_n":
            sig = sig[:32] + _b32(N)
        else:
            pub = _b32(P)
        lanes.add(edge, pub, dig, sig, 64, ref.SIG)
    for case in PRECEDENCE:
        pub, dig, sig = _signer(gen, lanes)
        bad = sig[:32] + _b32(N)
        if case == "size_over_hashtype":
            lanes.add(case, pub, dig, sig + b"\x00\x00", 66, ref.SIG_SIZE)
        elif case == "size_over_bad_sig":
            lanes.add(case, _b32(P), dig, bad[:63], 63, ref.SIG_SIZE)
        else:
            lanes.add(case, _b32(P), dig, bad + b"\x00", 65,
                      ref.SIG_HASHTYPE)
    for row in VECTORS:
        want = ref.OK if row["verification result"] == "TRUE" else ref.SIG
        lanes.add(f"vector_{row['index']}", bytes.fromhex(row["public key"]),
                  bytes.fromhex(row["message"]),
                  bytes.fromhex(row["signature"]), 64, want)
    return lanes


@pytest.fixture(scope="module")
def checked():
    """(lanes, the port's statuses, the reference's) of the one batch."""
    lanes = _build()
    arrays = lanes.arrays()
    got = bitcoin.verify_taproot_batch_arrays(*arrays, device=CPU)
    want = ref.statuses(*arrays, key_logs=lanes.logs)
    return lanes, got, want


CASES = (["seeded"] + [f"len_{n}" for n in LENGTHS]
         + [f"hashtype_{t:02x}" for t in HASH_TYPES]
         + [f"kind_{k}" for k in KINDS] + EDGES + PRECEDENCE
         + [f"vector_{r['index']}" for r in VECTORS])


def test_batch_shape_and_every_case_built(checked):
    lanes, got, want = checked
    assert sorted(lanes.cases) == sorted(CASES)
    assert 64 <= len(lanes.pubs) <= 256
    assert got.dtype == np.int32 and got.shape == (len(lanes.pubs),)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_case_against_reference(checked, case):
    lanes, got, want = checked
    idx = [i for i, _ in lanes.cases[case]]
    assert got[idx].tolist() == want[idx].tolist() == \
        [w for _, w in lanes.cases[case]]


def test_reference_on_the_vectors_without_known_logs():
    """The reference from the BIP alone: no discrete log given."""
    for row in VECTORS:
        sig = bytes.fromhex(row["signature"])
        got = ref.check(bytes.fromhex(row["public key"]),
                        bytes.fromhex(row["message"]), sig, 64)
        assert got == (ref.OK if row["verification result"] == "TRUE"
                       else ref.SIG), row["index"]


def test_host_parse_rules_and_inert_lanes():
    """Core's size and hash-type rules on the host, without the device:
    the rejected lanes carry the inert key and signature."""
    n = 16
    gen = np.random.default_rng(SEED)
    pubs = gen.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = gen.integers(0, 256, (n, 65), dtype=np.uint8)
    lens = np.array([64, 65, 65, 65, 63, 66, 0, 65, 65, 65, 65, 65, 65,
                     64, 64, 65], np.int32)
    sigs[:, 64] = [0, 1, 0, 4, 1, 1, 1, 2, 3, 0x81, 0x82, 0x83, 0x80, 7, 0,
                   0xFF]
    status, keys, sig64 = bitcoin._taproot_host_parse(pubs, sigs, lens)
    want = [0, 0, 12, 12, 1, 1, 1, 0, 0, 0, 0, 0, 12, 0, 0, 12]
    assert status.tolist() == want and status.dtype == np.int32
    bad = status != ec.OK
    assert (keys[bad] == bitcoin._INERT_X).all()
    assert (sig64[bad] == bitcoin._INERT_SIG).all()
    assert np.array_equal(keys[~bad], pubs[~bad])
    assert np.array_equal(sig64[~bad], sigs[~bad, :64])
    assert ref.lift_x(int.from_bytes(bitcoin._INERT_X.tobytes(), "big"))
    assert ec.MESSAGES[ec.ERR_SCHNORR_SIG_HASHTYPE]
    assert ec.ERR_SCHNORR_SIG_HASHTYPE == 12


def test_shapes_are_checked():
    keys = np.zeros((2, 32), np.uint8)
    with pytest.raises(ValueError, match="65"):
        bitcoin.verify_taproot_batch_arrays(
            keys, keys, np.zeros((2, 64), np.uint8),
            np.full(2, 64, np.int32), device=CPU)
    with pytest.raises(ValueError):
        bitcoin.verify_taproot_batch_arrays(
            keys, keys, np.zeros((2, 65), np.uint8),
            np.full(3, 64, np.int32), device=CPU)


def test_schnorr_verify_is_ok_of_the_status_helper():
    """`schnorr.verify_batch_arrays` is `status == OK` of the helper the
    Taproot check shares, on the same rows: the vectors and some seeded
    lanes, one of each with a flipped digest bit."""
    gen = np.random.default_rng(SEED + 1)
    lanes = Lanes()
    for _ in range(8):
        lanes.add("seeded", *_signer(gen, lanes), 64, ref.OK)
    for row in VECTORS:
        lanes.add("vector", bytes.fromhex(row["public key"]),
                  bytes.fromhex(row["message"]),
                  bytes.fromhex(row["signature"]), 64, None)
    pubs, digests, sigs, _ = lanes.arrays()
    digests[0, 5] ^= 1
    sig64 = np.ascontiguousarray(sigs[:, :64])
    ok = schnorr.verify_batch_arrays(pubs, digests, sig64, device=CPU)
    status = schnorr._verify_status_arrays(pubs, digests, sig64, None,
                                           torch.device(CPU))
    assert ok.dtype == bool and status.dtype == np.int32
    assert np.array_equal(ok, status == ec.OK)
    assert set(status.tolist()) <= {ec.OK, ec.ERR_INVALID_ENCODING,
                                    ec.ERR_VERIFY_FAILED}
    assert ok.tolist() == [ref.schnorr_verify(d.tobytes(), p.tobytes(),
                                              s.tobytes())
                           for p, d, s in zip(pubs, digests, sig64)]


def test_challenge_lanes_count_the_host_on_the_cpu(checked):
    """On the CPU every lane's challenge is the plain version's: the one
    batch again adds its lanes under "host" and none under "device"."""
    lanes, _, want = checked
    before = dict(schnorr.CHALLENGE_LANES)
    got = bitcoin.verify_taproot_batch_arrays(*lanes.arrays(), device=CPU)
    assert np.array_equal(got, want)
    assert schnorr.CHALLENGE_LANES == dict(
        before, host=before["host"] + len(lanes.pubs))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


BLOCK_LANES = 16384


@pytest.mark.card
def test_card_replayed_graph_equals_the_reference(card):
    """The one batch, every case and corruption kind, tiled to a block of
    16,384 lanes: a first call (capture or replay), then one that replays
    the core's graph, both with the reference's statuses, and each lane's
    challenge counted under "device"."""
    lanes = _build()
    arrays = lanes.arrays()
    want = ref.statuses(*arrays, key_logs=lanes.logs)
    pick = np.arange(BLOCK_LANES) % len(lanes.pubs)
    block = [a[pick] for a in arrays]
    before = dict(schnorr.CHALLENGE_LANES)
    first = bitcoin.verify_taproot_batch_arrays(*block, device=card)
    graphs = dict(schnorr.VERIFY_GRAPHS)
    second = bitcoin.verify_taproot_batch_arrays(*block, device=card)
    assert schnorr.VERIFY_GRAPHS == dict(
        graphs, replayed=graphs["replayed"] + 1)
    assert np.array_equal(first, want[pick])
    assert np.array_equal(second, want[pick])
    assert schnorr.CHALLENGE_LANES == dict(
        before, device=before["device"] + 2 * BLOCK_LANES)
