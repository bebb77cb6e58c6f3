"""The port's program spans (`utils/profiling.py`: `entry`, `span`,
`current`, `spans`) on the CPU.

- With no profiler session, an entry-point call of each of the five paths
  records nothing, makes no CUDA event and opens no profiler annotation;
  `span` and `entry` give the one inert object, as they do while the
  current stream captures a CUDA graph.
- Each path (the wallet signer `sign`, consensus ECDSA verify `verify`,
  Taproot verify `schnorr`, hash-to-curve `h2c`, the MSM `msm`) runs a few
  lanes once under `profiling.trace()`, a `torch.profiler` session: one
  `<path>.call` root, whose id every descendant shares as its call id;
  each child inside its parent's interval; the stages of the path and no
  other; the core's `lanes`.  For `sign`, one `sign.round` a round of
  `SignStats.rounds`, its `lanes` the shrinking high-R counts, each round
  with its planes, core and read-back.  The session's `trace.json` holds
  every span's name.
- The buffer keeps the newest `SPAN_RECORDS` records; `trace()` empties it.

On a card (marked `card`, skipped without one): no record from inside a
graph capture; the second call of a width reads `how` = "replayed" on its
`sign.core`, `verify.core` and `schnorr.core`, with device milliseconds;
the Chrome trace of one signing call holds every span on the host's row
beside the kernels, on their clock.  Run there with `python -m pytest
--noconftest -p no:cacheprovider -m card tests/test_torch_spans.py`:
nothing here imports JAX.
"""

import json
import time

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.models import bitcoin, h2c
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import msm
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.utils import hostcurve as hc
from secp256k1_tpu_torch.utils import profiling

# One intra-op thread: tier-1 runs several pytest workers on one host.
torch.set_num_threads(1)

CPU = "cpu"
DST = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"
# DER of r = s = 1 and SIGHASH_ALL: BIP-0066 valid, a failing signature.
DER_ONE = bytes.fromhex("300602010102010101")
GX_ROW = np.frombuffer(hc.GX.to_bytes(32, "big"), np.uint8)

# The stages under each path's root.
STAGES = {
    "sign": {"sign.round", "sign.planes", "sign.core", "sign.readback",
             "sign.der"},
    "verify": {"verify.parse", "verify.planes", "verify.decompress",
               "verify.core", "verify.readback"},
    "schnorr": {"schnorr.parse", "schnorr.planes", "schnorr.core",
                "schnorr.readback"},
    "h2c": {"h2c.planes", "h2c.core", "h2c.readback"},
    "msm": {"msm.window_sums", "msm.fold"},
}
PATHS = tuple(STAGES)


def _keys(rng, n):
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    keys[:, 0] &= 0x7F
    keys[:, 31] |= 1
    return keys


def _sign(device, n=3):
    """Seed 26's three lanes take two rounds: [3, 1] lanes."""
    rng = np.random.default_rng(26)
    stats = bitcoin.SignStats()
    bitcoin.sign_der_batch_arrays(
        _keys(rng, n), rng.integers(0, 256, (n, 32), dtype=np.uint8),
        device=device, stats=stats)
    return {"stats": stats, "lanes": n}


def _verify(device, n=6):
    rng = np.random.default_rng(25)
    pubs = np.concatenate([np.full((n, 1), 2, np.uint8),
                           np.tile(GX_ROW, (n, 1))], 1)
    sigs = np.zeros((n, 73), np.uint8)
    sigs[:, :len(DER_ONE)] = np.frombuffer(DER_ONE, np.uint8)
    bitcoin.verify_asn1_batch_arrays(
        pubs, rng.integers(0, 256, (n, 32), dtype=np.uint8), sigs,
        np.full(n, len(DER_ONE), np.int32), device=device)
    return {"lanes": 16}


def _schnorr(device, n=5):
    rng = np.random.default_rng(26)
    sigs = np.zeros((n, 65), np.uint8)
    sigs[:, :32] = GX_ROW
    sigs[:, 63] = 1
    bitcoin.verify_taproot_batch_arrays(
        np.tile(GX_ROW, (n, 1)), rng.integers(0, 256, (n, 32),
                                              dtype=np.uint8),
        sigs, np.full(n, 64), device=device)
    return {"lanes": n}


def _h2c(device, n=3):
    rows = np.zeros((n, 8), np.uint8)
    rows[0, :3] = np.frombuffer(b"abc", np.uint8)
    h2c.hash_to_curve_batch_arrays(rows, DST, np.array([3, 0, 8]),
                                   device=device)
    return {"lanes": n}


def _msm(device, n=4):
    ks = [3 + 7 * i for i in range(n)]
    pts = [hc.mul(5 + i, hc.G) for i in range(n)]

    def plane(vals):
        return torch.as_tensor(lb.int_to_limbs_batch(vals),
                               dtype=torch.int32, device=device)
    one = [1] * n
    msm.multi_scalar_mult(plane(ks), pt.Point(
        plane([p[0] for p in pts]), plane([p[1] for p in pts]), plane(one)))
    return {}


CALLS = {"sign": _sign, "verify": _verify, "schnorr": _schnorr, "h2c": _h2c,
         "msm": _msm}


@pytest.fixture(scope="module", params=PATHS)
def traced(request, tmp_path_factory):
    """One call of a path under `profiling.trace()`: (path, what the call
    reports, the records, the Chrome trace's events)."""
    path = request.param
    log_dir = tmp_path_factory.mktemp(path)
    with torch.inference_mode(), profiling.trace(str(log_dir)):
        info = CALLS[path](CPU)
    records = profiling.spans()
    with open(log_dir / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    return path, info, records, events


# -- off ---------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_no_session_records_nothing(monkeypatch, path):
    """With no profiler session a call appends no record, makes no CUDA
    event and opens no annotation."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a span was opened with spans off")
    before = profiling.spans()
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "Span", refuse)
    CALLS[path](CPU)
    assert profiling.spans() == before


def test_spans_off_are_the_inert_object():
    assert not torch.autograd._profiler_enabled()
    inert = profiling.INERT
    assert profiling.span("a.core", True) is inert
    assert profiling.entry("a") is inert and profiling.current() is inert
    with profiling.span("a.core") as sp:
        sp.lanes = 3                                     # goes nowhere
    assert sp is inert and not hasattr(inert, "lanes")


def test_spans_inside_a_graph_capture_are_inert(monkeypatch):
    """While the current stream captures, a session's spans are inert too
    (the capture stood in for here; the card case captures for real)."""
    with torch.profiler.profile():
        on = profiling.span("a.core")
        assert isinstance(on, profiling.Span)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert profiling.span("a.core", True) is profiling.INERT
        assert profiling.entry("a") is profiling.INERT


# -- on ----------------------------------------------------------------------

def _children(records):
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    return kids


def test_one_root_a_call_and_children_inside_parents(traced):
    path, info, records, _ = traced
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == [f"{path}.call"]
    root = roots[0]
    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)
    assert {r.call for r in records} == {root.id}
    assert {r.name for r in records} == STAGES[path] | {root.name}
    for r in records:
        assert r.t0 <= r.t1 and r.device_ms is None      # no card here
        if r is not root:
            up = by_id[r.parent]
            assert up.t0 <= r.t0 and r.t1 <= up.t1
    cores = [r for r in records if r.name.endswith(".core")]
    for r in cores:
        assert "how" not in r.counts                     # no graph off a card
    if "lanes" in info and path != "sign":
        assert [r.lanes for r in cores] == [info["lanes"]]


@pytest.mark.parametrize("traced", ["sign"], indirect=True)
def test_sign_rounds_follow_the_grind(traced):
    """One `sign.round` a round (round 0 included), numbered, its lanes n
    and then the high-R lanes left, summing to the DRBG seedings; each
    round's planes, core (of its lanes) and read-back; `sign.der` once."""
    _, info, records, _ = traced
    stats, kids = info["stats"], _children(records)
    root = kids[None][0]
    rounds = [r for r in kids[root.id] if r.name == "sign.round"]
    assert len(rounds) == stats.rounds >= 2
    assert [r.round for r in rounds] == list(range(stats.rounds))
    lanes = [r.lanes for r in rounds]
    assert lanes[0] == info["lanes"] and sum(lanes) == stats.seedings
    assert all(a >= b >= 1 for a, b in zip(lanes, lanes[1:]))
    for r in rounds:
        assert [k.name for k in sorted(kids[r.id], key=lambda k: k.t0)] == \
            ["sign.planes", "sign.core", "sign.readback"]
        assert [k.lanes for k in kids[r.id] if k.name == "sign.core"] == \
            [r.lanes]
    assert [r.name for r in kids[root.id]].count("sign.der") == 1


def test_trace_json_holds_every_span(traced):
    _, _, records, events = traced
    names = {ev.get("name") for ev in events if ev.get("ph") == "X"}
    assert {r.name for r in records} <= names


def test_counts_are_attributes_of_the_record():
    with torch.profiler.profile():
        with profiling.entry("x") as call:
            with profiling.span("x.core") as sp:
                sp.lanes = 7
                profiling.current().how = "eager"
            assert profiling.current() is call
    assert sp.counts == {"lanes": 7, "how": "eager"} and sp.lanes == 7
    assert (sp.parent, sp.call, call.parent, call.call) == \
        (call.id, call.id, None, call.id)
    with pytest.raises(AttributeError):
        sp.rounds


def test_an_entry_inside_a_span_opens_no_second_root():
    with torch.profiler.profile():
        with profiling.span("y.round") as outer:
            assert profiling.entry("y") is profiling.INERT
        assert isinstance(profiling.entry("y"), profiling.Span)
    assert outer.parent is None and outer.call == outer.id


def test_buffer_keeps_the_newest_and_trace_empties_it(tmp_path):
    extra = 5
    with torch.profiler.profile():
        for i in range(profiling.SPAN_RECORDS + extra):
            with profiling.span("z.stage") as sp:
                sp.i = i
    got = profiling.spans()
    assert len(got) == profiling.SPAN_RECORDS
    assert [got[0].i, got[-1].i] == [extra, profiling.SPAN_RECORDS + extra - 1]
    with profiling.trace(str(tmp_path)):
        assert profiling.spans() == []


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_graph_capture_records_nothing(card):
    """Under a profiler session a span opened while the stream captures a
    CUDA graph is inert and leaves no record; one opened after it
    records."""
    x = torch.ones(1024, device=card)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.profiler.profile():
        before = len(profiling.spans())
        with torch.cuda.graph(graph):
            with profiling.span("g.core", True) as inside:
                y = x + 1
        with profiling.span("g.after", True) as after:
            graph.replay()
        torch.cuda.synchronize()
    assert inside is profiling.INERT
    got = profiling.spans()[before:]
    assert [r.name for r in got] == ["g.after"] and got[0].device_ms >= 0
    assert torch.equal(y, x + 1)


@pytest.mark.card
@pytest.mark.parametrize("path", ["sign", "verify", "schnorr"])
def test_card_second_call_reads_replayed(card, path):
    """The second call of a width replays the core's graph: its `.core`
    spans read `how` = "replayed" and device milliseconds (records of
    earlier sessions in the buffer left out)."""
    call = {"sign": lambda: _sign(card, 512),
            "verify": lambda: _verify(card, 512),
            "schnorr": lambda: _schnorr(card, 512)}[path]
    call()
    t0 = time.perf_counter()
    with torch.profiler.profile():
        call()
    torch.cuda.synchronize()
    cores = [r for r in profiling.spans()
             if r.name == f"{path}.core" and r.t0 >= t0]
    assert cores and all(r.how == "replayed" for r in cores)
    assert all(r.device_ms is not None and r.device_ms > 0 for r in cores)


@pytest.mark.card
def test_card_trace_shows_spans_beside_kernels(card, tmp_path):
    """In the Chrome trace of one signing call, every span is on the
    host's row (`user_annotation`) and the kernels run inside the
    `sign.call` interval, on the same clock."""
    _sign(card, 4096)
    with profiling.trace(str(tmp_path)):
        _sign(card, 4096)
        torch.cuda.synchronize()
    names = {r.name for r in profiling.spans()}
    assert STAGES["sign"] | {"sign.call"} <= names
    with open(tmp_path / profiling.TRACE_FILE) as fh:
        events = [ev for ev in json.load(fh)["traceEvents"]
                  if ev.get("ph") == "X"]
    host = {ev["name"]: ev for ev in events
            if ev.get("cat") == "user_annotation" and ev["name"] in names}
    assert set(host) == names
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    call = host["sign.call"]
    assert kernels and all(
        call["ts"] <= k["ts"] <= call["ts"] + call["dur"] for k in kernels)
