"""The sign core's CUDA graphs (`models/ecdsa.py` `_sign_e2e_core`).

- On the CPU, `_sign_e2e_core` is `_sign_e2e_body` byte for byte, with and
  without extra data, at candidates 0 and 1, and counts nothing in
  `SIGN_GRAPHS`;
- `_sign_graph_key` gives no key for CPU planes, resample passes or planes
  the wrappers refuse, and one key a device, width, extra-data presence and
  fixed-base switch setting;
- on a card (marked `card`, skipped without one): at 16, 2,048 and 65,536
  lanes, with and without extra data, a replay answers what the eager body
  answers for the planes it was given, its answer is a copy that the next
  replay leaves alone, and it adds one `rfc6979_nonce` launch.  Run there
  with `python -m pytest --noconftest -p no:cacheprovider -m card
  tests/test_torch_sign_graph.py` (the card's machine has no JAX for
  `tests/conftest.py` to import).

This file imports no JAX: the card's cases compare the graph with the eager
body of the port itself.
"""

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.models import ecdsa
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt

# One intra-op thread: tier-1 runs several pytest workers on one host.
torch.set_num_threads(1)


def _rows(rng, lanes):
    """[lanes, 32] u8 keys in [1, n) (top bit clear, never zero) and
    reduced digests."""
    keys = rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
    keys[:, 0] &= 0x7F
    keys[:, 31] |= 1
    digests = rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
    return keys, ecdsa._reduce_digest_np(digests)


def _planes(rng, lanes, extra, device):
    """(key, reduced digest, extra or None) byte planes of `lanes` lanes."""
    keys, e_rows = _rows(rng, lanes)
    extra_rows = rng.integers(0, 256, (lanes, 32), dtype=np.uint8) \
        if extra else None
    return tuple(None if a is None else bt.byte_plane_np(a, lanes, device)
                 for a in (keys, e_rows, extra_rows))


def _equal(got, want):
    return len(got) == len(want) == 5 and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("attempt", [0, 1])
@pytest.mark.parametrize("extra", [False, True], ids=["no_extra", "extra"])
def test_cpu_core_is_the_eager_body(extra, attempt):
    planes = _planes(np.random.default_rng(19 + 2 * attempt + extra), 16,
                     extra, "cpu")
    counts = dict(ecdsa.SIGN_GRAPHS)
    graphs = dict(ecdsa._SIGN_GRAPH_OF)
    got = ecdsa._sign_e2e_core(*planes, attempt)
    want = ecdsa._sign_e2e_body(*planes, attempt)
    assert _equal(got, want)
    assert ecdsa.SIGN_GRAPHS == counts
    assert ecdsa._SIGN_GRAPH_OF == graphs
    assert not got[3].any() and not got[4].any()     # valid keys, no resample


class _CardPlane:
    """What `_sign_graph_key` reads of a plane on a card, for a host that
    may have none."""

    def __init__(self, width, rows=32, dtype=torch.uint8, index=0,
                 contiguous=True):
        self.device = torch.device("cuda", index)
        self.dtype = dtype
        self.shape = torch.Size([rows, width])
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


def _card_key(width, extra=False, attempt=0, **e_kwargs):
    return ecdsa._sign_graph_key(_CardPlane(width),
                                 _CardPlane(width, **e_kwargs),
                                 _CardPlane(width) if extra else None,
                                 attempt)


def test_graph_key_none_off_the_card_and_for_resamples():
    cpu = torch.zeros((32, 16), dtype=torch.uint8)
    assert ecdsa._sign_graph_key(cpu, cpu, None, 0) is None
    assert ecdsa._sign_graph_key(cpu, cpu, cpu, 0) is None
    assert _card_key(16) is not None
    for attempt in (1, 2, 8):
        assert _card_key(16, attempt=attempt) is None
        assert _card_key(16, extra=True, attempt=attempt) is None


@pytest.mark.parametrize("e_kwargs", [
    {"rows": 31}, {"dtype": torch.int32}, {"index": 1},
    {"contiguous": False}], ids=["rows", "dtype", "device", "strided"])
def test_graph_key_none_for_planes_the_wrappers_refuse(e_kwargs):
    assert _card_key(2048, **e_kwargs) is None
    assert ecdsa._sign_graph_key(_CardPlane(2048), _CardPlane(1024), None,
                                 0) is None


def test_graph_key_by_width_extra_data_and_switches(monkeypatch):
    widths = [1 << k for k in range(4, 17)]
    keys = {(w, extra): _card_key(w, extra=extra)
            for w in widths for extra in (False, True)}
    assert len(set(keys.values())) == 2 * len(widths)
    assert all(_card_key(w, extra=x) == key for (w, x), key in keys.items())
    monkeypatch.setattr(tbl, "_BASE_WINDOW", 12)
    assert _card_key(65536) != keys[(65536, False)]
    monkeypatch.setattr(tbl, "_BASE_WINDOW", 8)
    monkeypatch.setattr(tbl, "_BASE_SIGNED", False)
    assert _card_key(65536) != keys[(65536, False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("extra", [False, True], ids=["no_extra", "extra"])
@pytest.mark.parametrize("lanes", [16, 2048, 65536])
def test_card_replay_equals_the_eager_body(card, lanes, extra):
    rng = np.random.default_rng(lanes + extra)
    first, second = (_planes(rng, lanes, extra, card) for _ in range(2))
    ecdsa._sign_e2e_core(*first, 0)                  # captures, or replays
    want = ecdsa._sign_e2e_body(*second, 0)
    counts = dict(ecdsa.SIGN_GRAPHS)
    drbg = K.LAUNCHES["rfc6979_nonce"]
    got = ecdsa._sign_e2e_core(*second, 0)
    torch.cuda.synchronize()
    assert ecdsa.SIGN_GRAPHS == dict(counts, replayed=counts["replayed"] + 1)
    assert K.LAUNCHES["rfc6979_nonce"] == drbg + 1
    assert _equal(got, want)
    again = ecdsa._sign_e2e_core(*first, 0)
    assert _equal(again, ecdsa._sign_e2e_body(*first, 0))
    assert _equal(got, want)                         # a copy, not the graph's
    assert K.LAUNCHES["rfc6979_nonce"] == drbg + 3
