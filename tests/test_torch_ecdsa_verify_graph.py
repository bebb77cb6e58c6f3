"""The ECDSA verify stage's CUDA graphs (`models/ecdsa.py` `_verify_stage`,
behind `_verify_e2e_core` and `_verify_e2e_mixed_core`).

- `_verify_graph_key` gives no key for CPU planes, planes the wrappers
  refuse (byte planes, want_odd and is_unc flags, host statuses) or a
  width above `VERIFY_GRAPH_MAX_LANES`, and one key a device, width,
  33/65-byte layout, `reject_malleable`, host-status presence and GLV and
  fixed-base switch setting;
- on the CPU, `_verify_e2e_core` and `_verify_e2e_mixed_core` are the
  eager stage (`_verify_stage_body` over `_verify_impl`) status for
  status, call the core as the module holds `_verify_impl`, and count
  nothing in `ECDSA_VERIFY_GRAPHS`;
- on a card (marked `card`, skipped without one): at 16, 2,047, 2,048
  (either side of `invert_auto`'s switch to the batch inversion), 8,192 and
  65,536 lanes, with 33-byte and mixed 65-byte keys and `reject_malleable`
  off and on, a replay answers what the eager stage answers for the planes
  it was given (valid lanes; a host status, high s, a flipped digest bit,
  a key off the curve, r = 0, the r + n branch; an uncompressed key off
  the curve), its answer is a copy that the next replay leaves alone, and
  it adds one #4 `k_glv_signed` and one #5 `k_base_final` launch; two
  threads replaying one key with different planes, one on its own stream,
  each get their own statuses.  Run there with `python -m pytest
  --noconftest -p no:cacheprovider -m card
  tests/test_torch_ecdsa_verify_graph.py` (the card's machine has no JAX
  for `tests/conftest.py` to import).

This file imports no JAX: the card's cases compare the graph with the eager
stage of the port itself.
"""

import threading

import numpy as np
import pytest
import torch

from ecdsa_cases import big_r_triple
from secp256k1_tpu_torch.models import ecdsa
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host.
torch.set_num_threads(1)

SIGNERS = 8
# The GLV kernel (#4) and the fixed-base kernel (#5) that one verify
# launches once each.
GLV = "glv_windowed_mult_signed_from_points"
BASE = "base_windowed_add_final"
# Lanes 0-6 hold one case each (the last only with 65-byte keys); the
# others are valid signatures, their keys 65 bytes on odd lanes of the
# mixed layout.
HOST, HIGH_S, DIGEST, OFF_CURVE, R_ZERO, R_PLUS_N, UNC_OFF_CURVE = range(7)
LAYOUTS = {"33": False, "65": True}


def _row(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "big"), np.uint8)


def _off_curve_x(rng) -> int:
    while True:
        x = int.from_bytes(rng.bytes(32), "big") % hc.P
        if hc.lift_x(x, False) is None:
            return x


def _signers(rng):
    """SIGNERS (key point, digest, r, low s) of seeded python-int ECDSA."""
    out = []
    for _ in range(SIGNERS):
        d, k = (int.from_bytes(rng.bytes(32), "big") % (hc.N - 1) + 1
                for _ in range(2))
        digest = rng.bytes(32)
        e = int.from_bytes(digest, "big") % hc.N
        r = hc.mul(k, hc.G)[0] % hc.N
        s = pow(k, hc.N - 2, hc.N) * (e + r * d) % hc.N
        out.append((hc.mul(d, hc.G), digest, r, min(s, hc.N - s)))
    return out


def _rows(rng, lanes, mixed, reject_malleable):
    """(planes' rows: want_odd, is_unc or None, x, y or None, digest, r, s,
    host status; each lane's expected status)."""
    table = _signers(rng)
    pick = rng.integers(0, SIGNERS, lanes)
    qx, qy, dig, r, s = (np.stack([_row(v) for v in col])[pick]
                         for col in ([t[0][0] for t in table],
                                     [t[0][1] for t in table],
                                     [int.from_bytes(t[1], "big")
                                      for t in table],
                                     [t[2] for t in table],
                                     [t[3] for t in table]))
    odd = np.array([t[0][1] % 2 == 1 for t in table])[pick]
    host = np.zeros(lanes, np.int32)
    want = np.zeros(lanes, np.int32)
    host[HOST] = want[HOST] = ec.ERR_INVALID_ENCODING
    r[HOST] = s[HOST] = _row(1)                        # the host's inert fill
    s[HIGH_S] = _row(hc.N - int.from_bytes(s[HIGH_S].tobytes(), "big"))
    if reject_malleable:
        want[HIGH_S] = ec.ERR_MALLEABLE
    dig[DIGEST, 31] ^= 0x04
    want[DIGEST] = ec.ERR_V_NEQ_R
    qx[OFF_CURVE] = _row(_off_curve_x(rng))
    want[OFF_CURVE] = ec.ERR_INVALID_PUBLIC_KEY
    r[R_ZERO] = 0
    want[R_ZERO] = ec.ERR_INVALID_SIGNATURE
    q, digest, r_big, s_big = big_r_triple()
    qx[R_PLUS_N], qy[R_PLUS_N] = _row(q[0]), _row(q[1])
    odd[R_PLUS_N] = q[1] % 2 == 1
    dig[R_PLUS_N] = np.frombuffer(digest, np.uint8)
    r[R_PLUS_N], s[R_PLUS_N] = _row(r_big), _row(s_big)
    if not mixed:
        return (odd, None, qx, None, dig, r, s, host), want
    unc = np.arange(lanes) % 2 == 1
    unc[[OFF_CURVE, R_PLUS_N]] = False
    unc[UNC_OFF_CURVE] = True
    qy[UNC_OFF_CURVE, 31] ^= 0x01
    want[UNC_OFF_CURVE] = ec.ERR_INVALID_PUBLIC_KEY
    qy[~unc] = 0                                       # 33-byte keys' pad
    return (odd & ~unc, unc, qx, qy, dig, r, s, host), want


def _planes(rows, device):
    """The stage's planes from `_rows`' rows: flags and statuses [B],
    bytes [32, B]."""
    lanes = rows[0].shape[0]
    return tuple(
        None if a is None else
        torch.as_tensor(a, device=device) if a.ndim == 1 else
        bt.byte_plane_np(a, lanes, device) for a in rows)


def _eager(planes, reject_malleable):
    """The stage run eagerly, the core as `_verify_impl`."""
    return ecdsa._verify_stage_body(ecdsa._verify_impl, reject_malleable,
                                    *planes)[0]


def _core(planes, reject_malleable):
    """The stage through the entry the planes' layout takes."""
    odd, unc, x, y, e, r, s, host = planes
    if unc is None:
        return ecdsa._verify_e2e_core(odd, x, e, r, s, reject_malleable,
                                      host)
    return ecdsa._verify_e2e_mixed_core(odd, unc, x, y, e, r, s,
                                        reject_malleable, host)


@pytest.mark.parametrize("reject_malleable", [False, True],
                         ids=["malleable", "low_s"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cpu_core_is_the_eager_body(layout, reject_malleable):
    rows, want = _rows(np.random.default_rng(25), 16, LAYOUTS[layout],
                       reject_malleable)
    planes = _planes(rows, "cpu")
    counts = dict(ecdsa.ECDSA_VERIFY_GRAPHS)
    got = _core(planes, reject_malleable)
    body = _eager(planes, reject_malleable)
    assert got.dtype == body.dtype == torch.int32
    assert torch.equal(got, body)
    assert got.tolist() == want.tolist()
    assert ecdsa.ECDSA_VERIFY_GRAPHS == counts


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cpu_core_calls_verify_impl_as_the_module_holds_it(monkeypatch,
                                                           layout):
    """A wrapper installed over `ecdsa._verify_impl` (a harness's timing or
    fault) runs on the eager stage, once a call."""
    rows, want = _rows(np.random.default_rng(27), 16, LAYOUTS[layout], True)
    calls = []

    def wrapped(*args):
        calls.append(args[0].shape[-1])
        return ecdsa._verify_core(*args)
    monkeypatch.setattr(ecdsa, "_verify_impl", wrapped)
    got = _core(_planes(rows, "cpu"), True)
    assert calls == [16]
    assert got.tolist() == want.tolist()


class _CardPlane:
    """What `_verify_graph_key` reads of a plane on a card, for a host
    that may have none."""

    def __init__(self, shape, dtype, index=0, contiguous=True):
        self.device = torch.device("cuda", index)
        self.dtype = dtype
        self.shape = torch.Size(shape)
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


# The stage's planes by position, and what each is on the card.
PLANES = ("want_odd", "is_unc", "x", "y", "e", "r", "s", "host")
DTYPES = {"want_odd": torch.bool, "is_unc": torch.bool,
          "host": torch.int32}


def _card_planes(width, mixed=True, host=True, bad=None, **bad_kwargs):
    """Fake card planes of `width` lanes; the plane named `bad` made with
    `bad_kwargs` (`shape`, `dtype`, `index`, `contiguous`)."""
    out = []
    for name in PLANES:
        if (name in ("is_unc", "y") and not mixed) or (name == "host"
                                                       and not host):
            out.append(None)
            continue
        kwargs = {"shape": (width,) if name in DTYPES else (32, width),
                  "dtype": DTYPES.get(name, torch.uint8)}
        if name == bad:
            kwargs.update(bad_kwargs)
        out.append(_CardPlane(**kwargs))
    return tuple(out)


def _card_key(width, mixed=True, reject_malleable=False, host=True):
    return ecdsa._verify_graph_key(_card_planes(width, mixed, host),
                                   reject_malleable)


def test_graph_key_none_off_the_card():
    rows, _ = _rows(np.random.default_rng(26), 16, True, False)
    assert ecdsa._verify_graph_key(_planes(rows, "cpu"), False) is None
    assert _card_key(16) is not None


@pytest.mark.parametrize("mixed", [False, True], ids=["33", "65"])
def test_graph_key_none_above_the_widest_graph(mixed):
    widest = ecdsa.VERIFY_GRAPH_MAX_LANES
    assert _card_key(widest, mixed) is not None
    assert _card_key(2 * widest, mixed) is None


BAD = {
    "rows": ("x", {"shape": (31, 2048)}),
    "y_width": ("y", {"shape": (32, 1024)}),
    "bytes_dtype": ("e", {"dtype": torch.int32}),
    "bytes_device": ("r", {"index": 1}),
    "bytes_strided": ("s", {"contiguous": False}),
    "flag_dtype": ("want_odd", {"dtype": torch.uint8}),
    "flag_width": ("is_unc", {"shape": (1024,)}),
    "flag_device": ("want_odd", {"index": 1}),
    "flag_strided": ("is_unc", {"contiguous": False}),
    "host_dtype": ("host", {"dtype": torch.int64}),
    "host_width": ("host", {"shape": (2048, 1)}),
    "host_device": ("host", {"index": 1}),
    "host_strided": ("host", {"contiguous": False}),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_graph_key_none_for_planes_the_wrappers_refuse(bad):
    name, kwargs = BAD[bad]
    assert ecdsa._verify_graph_key(_card_planes(2048), False) is not None
    assert ecdsa._verify_graph_key(
        _card_planes(2048, bad=name, **kwargs), False) is None


@pytest.mark.parametrize("switch,value", [
    ("base_window", 12), ("base_signed", False), ("mega", False),
    ("mega_signed", False)])
def test_graph_key_by_width_layout_flags_and_switches(monkeypatch, switch,
                                                      value):
    widths = [16, 2047, 2048, 8192, 65536]
    settings = [(w, mixed, rm, host) for w in widths
                for mixed in (False, True) for rm in (False, True)
                for host in (False, True)]
    keys = {s: _card_key(*s) for s in settings}
    assert None not in keys.values()
    assert len(set(keys.values())) == len(settings)
    assert all(_card_key(*s) == key for s, key in keys.items())
    module, name = {"base_window": (tbl, "_BASE_WINDOW"),
                    "base_signed": (tbl, "_BASE_SIGNED"),
                    "mega": (K, "_MEGA"),
                    "mega_signed": (K, "_MEGA_SIGNED")}[switch]
    monkeypatch.setattr(module, name, value)
    assert all(_card_key(*s) != key for s, key in keys.items())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("reject_malleable", [False, True],
                         ids=["malleable", "low_s"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("lanes", [16, 2047, 2048, 8192, 65536])
def test_card_replay_equals_the_eager_body(card, lanes, layout,
                                           reject_malleable):
    rng = np.random.default_rng(4 * lanes + 2 * LAYOUTS[layout]
                                + reject_malleable)
    (first, _), (second, want_rows) = (
        (_planes(rows, card), want) for rows, want in (
            _rows(rng, lanes, LAYOUTS[layout], reject_malleable)
            for _ in range(2)))
    _core(first, reject_malleable)                   # captures, or replays
    want = _eager(second, reject_malleable)
    assert want.cpu().numpy().tolist() == want_rows.tolist()
    counts = dict(ecdsa.ECDSA_VERIFY_GRAPHS)
    glv, base = K.LAUNCHES[GLV], K.LAUNCHES[BASE]
    got = _core(second, reject_malleable)
    torch.cuda.synchronize()
    assert ecdsa.ECDSA_VERIFY_GRAPHS == dict(
        counts, replayed=counts["replayed"] + 1)
    assert (K.LAUNCHES[GLV], K.LAUNCHES[BASE]) == (glv + 1, base + 1)
    assert torch.equal(got, want)
    again = _core(first, reject_malleable)
    assert torch.equal(again, _eager(first, reject_malleable))
    assert torch.equal(got, want)                    # a copy, not the graph's
    assert (K.LAUNCHES[GLV], K.LAUNCHES[BASE]) == (glv + 3, base + 3)


@pytest.mark.card
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_card_threads_replaying_one_key_get_their_own_statuses(
        card, monkeypatch, layout):
    """Two threads replay one key over different planes, the second on a
    stream of its own, each graph replay slowed on the host so that an
    unguarded copy-in of the other thread would land between a thread's
    copy-in and its replay: every answer is the thread's own."""
    rng = np.random.default_rng(29 + LAYOUTS[layout])
    rows = [_rows(rng, 2048, LAYOUTS[layout], True)[0] for _ in range(2)]
    rows[1][4][UNC_OFF_CURVE + 1::3, 31] ^= 0x01    # a third fail the digest
    sides = [_planes(r, card) for r in rows]
    wants = [_eager(planes, True) for planes in sides]
    assert not torch.equal(wants[0], wants[1])
    _core(sides[0], True)                            # captures, or replays
    torch.cuda.synchronize()
    replay = torch.cuda.CUDAGraph.replay

    def slow_replay(graph):
        threading.Event().wait(0.002)
        replay(graph)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", slow_replay)
    wrong, errors = [0, 0], []

    def drive(side, stream):
        try:
            with torch.cuda.stream(stream):
                for _ in range(25):
                    got = _core(sides[side], True)
                    wrong[side] += not torch.equal(got, wants[side])
            stream.synchronize()
        except Exception as exc:                     # reported below
            errors.append(exc)
    threads = [threading.Thread(target=drive, args=(side, stream))
               for side, stream in ((0, torch.cuda.current_stream()),
                                    (1, torch.cuda.Stream()))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and wrong == [0, 0]
