"""The readers of the program's own spans (`program_spans.py` and
`metrics/planes_ms.py`, `readback_ms.py`, `grind_self_ms.py`,
`graph_replay_pct.py`) on a made-up run with hand-made records, on the CPU
(`python -m pytest benchmark/`): sums within each profiled call, self time
with nested children, the replayed share, records outside the calls left
out, and None where the program keeps no spans, no call was profiled, or
a call has no span of the kind."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import harness
from secp256k1_tpu_torch.utils import profiling

NAMES = ("planes_ms.custody", "planes_ms.block", "planes_ms.taproot",
         "planes_ms.ro", "readback_ms.custody", "readback_ms.taproot",
         "readback_ms.ro", "grind_self_ms.custody",
         "graph_replay_pct.custody", "graph_replay_pct.taproot")


def _rec(name, rid, parent, t0, t1, **counts):
    return SimpleNamespace(name=name, id=rid, parent=parent, call=None,
                           t0=t0, t1=t1, counts=counts, device_ms=None)


def _signing_call(base, first_id, second_how):
    """A signing call at host time `base` (1 s long): two rounds of 400
    and 300 ms, each with planes, core and read-back, then DER."""
    i = first_id
    b = base
    return [
        _rec("sign.call", i, None, b, b + 1.0),
        _rec("sign.round", i + 1, i, b + 0.1, b + 0.5, lanes=8, round=0),
        _rec("sign.planes", i + 2, i + 1, b + 0.1, b + 0.15),
        _rec("sign.core", i + 3, i + 1, b + 0.15, b + 0.3, lanes=8,
             how="replayed"),
        _rec("sign.readback", i + 4, i + 1, b + 0.3, b + 0.45),
        _rec("sign.round", i + 5, i, b + 0.5, b + 0.8, lanes=4, round=1),
        _rec("sign.planes", i + 6, i + 5, b + 0.5, b + 0.52),
        _rec("sign.core", i + 7, i + 5, b + 0.52, b + 0.6, lanes=4,
             how=second_how),
        _rec("sign.readback", i + 8, i + 5, b + 0.6, b + 0.7),
        _rec("sign.der", i + 9, i, b + 0.8, b + 0.9),
    ]


def _read(run, name):
    return harness.load_module(harness.metric_path(name)).read(run)


@pytest.fixture
def run(monkeypatch):
    """A run of two profiled calls, [0, 1] and [2, 3] s, whose program
    keeps the records that `records` holds."""
    r = harness.Run(None, 0.0)
    r.records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(r.records))
    r.profiled_calls = [harness.Call(t, t + 1.0, 0, "profile", None, None)
                        for t in (0.0, 2.0)]
    return r


def test_every_name_falls_back_to_a_reader():
    for name in NAMES:
        assert harness.metric_path(name).endswith(
            name.split(".", 1)[0] + ".py")


def test_none_without_the_program_spans(run, monkeypatch):
    run.records = _signing_call(0.0, 1, "replayed")
    monkeypatch.delattr(profiling, "spans")
    assert all(_read(run, n) is None for n in NAMES)


def test_none_without_profiled_calls(run):
    run.records = _signing_call(0.0, 1, "replayed")
    run.profiled_calls = []
    assert all(_read(run, n) is None for n in NAMES)


def test_none_where_a_call_has_no_span_of_the_kind(run):
    """The first call has its spans, the second none: every reader is
    None; a run of stages without `how` has no replayed share."""
    run.records = _signing_call(0.0, 1, "replayed")
    assert all(_read(run, n) is None for n in NAMES[:8])
    run.records = [_rec("h2c.call", 1, None, 0.0, 0.5),
                   _rec("h2c.core", 2, 1, 0.1, 0.2, lanes=3),
                   _rec("h2c.call", 3, None, 2.0, 2.5),
                   _rec("h2c.core", 4, 3, 2.1, 2.2, lanes=3)]
    assert _read(run, "graph_replay_pct.ro") is None


def test_sums_self_time_and_replayed_share(run):
    """Two signing calls (the second's last core eager) and a record
    outside both: planes 50 + 20 ms, read-back 150 + 100 ms a call; the
    rounds' self time 400 - 50 - 150 - 150 + 300 - 20 - 80 - 100 ms; three
    of four cores replayed."""
    run.records = (_signing_call(0.0, 1, "replayed")
                   + _signing_call(2.0, 11, "eager")
                   + [_rec("sign.planes", 99, None, 5.0, 6.0),
                      _rec("sign.core", 98, None, 5.0, 5.5,
                           how="captured")])
    assert _read(run, "planes_ms.custody") == pytest.approx(70.0)
    assert _read(run, "readback_ms.custody") == pytest.approx(250.0)
    assert _read(run, "grind_self_ms.custody") == pytest.approx(150.0)
    assert _read(run, "graph_replay_pct.custody") == pytest.approx(75.0)


def test_self_time_leaves_out_only_direct_children(run):
    """A grandchild inside a child is part of the child, not subtracted
    again; the summed host ms of a suffix take every path's stage."""
    for base, first in ((0.0, 1), (2.0, 11)):
        run.records += [
            _rec("sign.round", first, None, base, base + 0.5),
            _rec("sign.core", first + 1, first, base + 0.1, base + 0.3),
            _rec("x.inner", first + 2, first + 1, base + 0.1, base + 0.2),
            _rec("verify.planes", first + 3, None, base + 0.6, base + 0.7),
            _rec("verify.readback", first + 4, None, base + 0.7,
                 base + 0.75)]
    assert _read(run, "grind_self_ms.custody") == pytest.approx(300.0)
    assert _read(run, "planes_ms.block") == pytest.approx(100.0)
    assert _read(run, "readback_ms.taproot") == pytest.approx(50.0)
