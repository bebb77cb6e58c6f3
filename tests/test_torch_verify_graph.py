"""The Schnorr verify core's CUDA graphs (`models/schnorr.py`
`_schnorr_verify_e2e_core`).

- On the CPU, `_schnorr_verify_e2e_core` is `_schnorr_verify_e2e_body`
  value for value and counts nothing in `VERIFY_GRAPHS`;
- `_verify_graph_key` gives no key for CPU planes or planes the wrappers
  refuse, and one key a device, width, message length and GLV and
  fixed-base switch setting;
- on a card (marked `card`, skipped without one): at 16, 2,048, 16,384 and
  65,536 lanes a replay answers what the eager body answers for the
  planes it was given (valid lanes, a flipped message byte, s >= n, a key
  off the curve), its answer is a copy that the next replay leaves alone,
  and it adds one #4 `k_glv_signed` and one `k_bip340_challenge` launch.  Run there with `python -m pytest
  --noconftest -p no:cacheprovider -m card tests/test_torch_verify_graph.py`
  (the card's machine has no JAX for `tests/conftest.py` to import).

This file imports no JAX: the card's cases compare the graph with the eager
body of the port itself.
"""

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.models import schnorr
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host.
torch.set_num_threads(1)

SIGNERS = 8
# The GLV kernel (#4 `k_glv_signed`) and the challenge hash that one
# verify launches once each.
GLV = "glv_windowed_mult_signed_from_points"
CHALLENGE = "bip340_challenge"


def _b32(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _even(d: int):
    """(d or n - d, x of d*G), the secret that gives the even-y point."""
    q = hc.mul(d, hc.G)
    return (d if q[1] % 2 == 0 else hc.N - d), q[0]


def _off_curve_x(rng) -> bytes:
    while True:
        x = int.from_bytes(rng.bytes(32), "big") % hc.P
        if hc.lift_x(x, False) is None:
            return _b32(x)


def _rows(rng, lanes):
    """[lanes, 32] u8 x-only keys, r, s and messages of BIP-0340
    signatures by a few seeded keys (python ints), then one lane each of
    a flipped message byte, s >= n and a key x off the curve."""
    table = []
    for _ in range(SIGNERS):
        d, px = _even(int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1)
        k, rx = _even(int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1)
        msg = rng.bytes(32)
        e = schnorr.tagged_hash(schnorr.TAG_CHALLENGE, _b32(rx), _b32(px),
                                msg)
        s = (k + int.from_bytes(e, "big") % hc.N * d) % hc.N
        table.append([_b32(v) for v in (px, rx, s)] + [msg])
    pick = rng.integers(0, SIGNERS, lanes)
    cols = [np.frombuffer(b"".join(table[i][j] for i in pick),
                          np.uint8).reshape(lanes, 32).copy()
            for j in range(4)]
    pubs, rs, ss, msgs = cols
    msgs[0, 5] ^= 0x10
    ss[1] = np.frombuffer(_b32(hc.N), np.uint8)
    pubs[2] = np.frombuffer(_off_curve_x(rng), np.uint8)
    return pubs, rs, ss, msgs


def _planes(rng, lanes, device):
    return tuple(bt.byte_plane_np(a, lanes, device)
                 for a in _rows(rng, lanes))


def test_cpu_core_is_the_eager_body():
    planes = _planes(np.random.default_rng(20), 16, "cpu")
    counts = dict(schnorr.VERIFY_GRAPHS)
    got = schnorr._schnorr_verify_e2e_core(*planes)
    want = schnorr._schnorr_verify_e2e_body(*planes)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert schnorr.VERIFY_GRAPHS == counts
    assert (got[3:] == 0).all() and (got[:3] != 0).all()


class _CardPlane:
    """What `_verify_graph_key` reads of a plane on a card, for a host
    that may have none."""

    def __init__(self, width, rows=32, dtype=torch.uint8, index=0,
                 contiguous=True):
        self.device = torch.device("cuda", index)
        self.dtype = dtype
        self.shape = torch.Size([rows, width])
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


def _card_key(width, msg_rows=32, **s_kwargs):
    return schnorr._verify_graph_key(
        (_CardPlane(width), _CardPlane(width), _CardPlane(width, **s_kwargs),
         _CardPlane(width, rows=msg_rows)))


def test_graph_key_none_off_the_card():
    cpu = torch.zeros((32, 16), dtype=torch.uint8)
    assert schnorr._verify_graph_key((cpu, cpu, cpu, cpu)) is None
    assert _card_key(16) is not None


@pytest.mark.parametrize("s_kwargs", [
    {"rows": 31}, {"dtype": torch.int32}, {"index": 1},
    {"contiguous": False}], ids=["rows", "dtype", "device", "strided"])
def test_graph_key_none_for_planes_the_wrappers_refuse(s_kwargs):
    assert _card_key(2048, **s_kwargs) is None
    assert schnorr._verify_graph_key(
        (_CardPlane(2048), _CardPlane(2048), _CardPlane(1024),
         _CardPlane(2048))) is None
    msgs = [_CardPlane(1024)]
    if "rows" not in s_kwargs:                 # a message has any length
        msgs.append(_CardPlane(2048, **s_kwargs))
    for msg in msgs:
        assert schnorr._verify_graph_key(
            (_CardPlane(2048), _CardPlane(2048), _CardPlane(2048),
             msg)) is None


@pytest.mark.parametrize("switch,value", [
    ("base_window", 12), ("base_signed", False), ("mega", False),
    ("mega_signed", False)])
def test_graph_key_by_width_and_switches(monkeypatch, switch, value):
    widths = [1 << k for k in range(4, 17)]
    keys = {w: _card_key(w) for w in widths}
    assert len(set(keys.values())) == len(widths)
    assert all(_card_key(w) == key for w, key in keys.items())
    module, name = {"base_window": (tbl, "_BASE_WINDOW"),
                    "base_signed": (tbl, "_BASE_SIGNED"),
                    "mega": (K, "_MEGA"),
                    "mega_signed": (K, "_MEGA_SIGNED")}[switch]
    monkeypatch.setattr(module, name, value)
    assert _card_key(16384) != keys[16384]


def test_graph_key_by_message_length():
    """One key a message length, any length (0 included) at one width."""
    lengths = [0, 1, 32, 55, 56, 64, 100]
    keys = {n: _card_key(16384, msg_rows=n) for n in lengths}
    assert None not in keys.values()
    assert len(set(keys.values())) == len(lengths)
    assert keys[32] == _card_key(16384)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("lanes", [16, 2048, 16384, 65536])
def test_card_replay_equals_the_eager_body(card, lanes):
    rng = np.random.default_rng(lanes)
    first, second = (_planes(rng, lanes, card) for _ in range(2))
    schnorr._schnorr_verify_e2e_core(*first)         # captures, or replays
    want = schnorr._schnorr_verify_e2e_body(*second)
    counts = dict(schnorr.VERIFY_GRAPHS)
    glv, challenge = K.LAUNCHES[GLV], K.LAUNCHES[CHALLENGE]
    got = schnorr._schnorr_verify_e2e_core(*second)
    torch.cuda.synchronize()
    assert schnorr.VERIFY_GRAPHS == dict(counts,
                                         replayed=counts["replayed"] + 1)
    assert K.LAUNCHES[GLV] == glv + 1
    assert K.LAUNCHES[CHALLENGE] == challenge + 1
    assert torch.equal(got, want)
    assert (want[3:] == 0).all() and (want[:3] != 0).all()
    again = schnorr._schnorr_verify_e2e_core(*first)
    assert torch.equal(again, schnorr._schnorr_verify_e2e_body(*first))
    assert torch.equal(got, want)                    # a copy, not the graph's
    assert K.LAUNCHES[GLV] == glv + 3
    assert K.LAUNCHES[CHALLENGE] == challenge + 3
