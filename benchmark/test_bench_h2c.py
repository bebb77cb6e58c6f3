"""The `h2c.ro` cell's own tests, on the CPU (`python -m pytest
benchmark/`): the plain RFC 9380 reference against every J.8.1 RO vector
(u, Q0, Q1 and P) and the expand_message_xmd vectors; the seeded ring
(the length mix, the long and planted lanes, distinct messages); the cell
through the program's plain path at a tiny size (whole, broken
underneath, and its control lane by lane); its metric readers on a
made-up record; its failure at `bind` on a program whose arrays entry
takes no lengths.  On a card (`-m card`), the cell's own run and its
control at the cell's own size."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pytest

import harness
from reference import curve, h2c
from test_bench_harness import ROOT, SEED

WORKLOAD = "h2c.ro"
TESTDATA = os.path.join(ROOT, "tests", "testdata")


def _vectors(name):
    with open(os.path.join(TESTDATA, name)) as fh:
        return json.load(fh)


def tiny() -> harness.CellSpec:
    cs = harness.load_cell(ROOT, WORKLOAD)
    cs.mix.update(lanes=16, ring=2, long_share=2 / 16)
    return cs


def _cell(cs=None, seed=SEED):
    cs = cs or tiny()
    return harness.load_module(cs.entry_path).Cell(cs.config, cs.mix, seed)


def test_cell_as_declared():
    cs = harness.load_cell(ROOT, WORKLOAD)
    assert cs.chips == 1 and cs.config["reduced"] == {}
    assert cs.mix["lanes"] == 65536 and cs.mix["ring"] == 4
    assert (cs.mix["min_len"], cs.mix["max_len"]) == (0, 128)
    assert cs.mix["long_len"] == 517 and cs.mix["long_share"] == 1 / 64
    suite = _vectors("secp256k1_XMD_SHA-256_SSWU_RO_.json")
    assert cs.config["dst"] == suite["dst"]
    assert cs.mix["planted"] == [v["msg"] for v in suite["vectors"]]
    assert {m["name"] for m in cs.per_layer} == {
        "h2c_expand_ms.ro", "h2c_map_ms.ro", "h2c_host_ms.ro",
        "xmd_host_blocks.ro", "device_idle_pct.h2c",
        "device_ops_per_call.h2c"}
    assert {m["name"] for m in cs.end_to_end} == {"ops_per_s", "setup_s"}


# -- the reference ----------------------------------------------------------

def test_reference_gives_every_ro_vector():
    """u0, u1, Q0, Q1 and P of every J.8.1 vector."""
    suite = _vectors("secp256k1_XMD_SHA-256_SSWU_RO_.json")
    dst = suite["dst"].encode()

    def pt(d):
        return int(d["x"], 16), int(d["y"], 16)
    for v in suite["vectors"]:
        msg = v["msg"].encode()
        us = h2c.hash_to_field(msg, dst)
        assert us == [int(u, 16) for u in v["u"]], v["msg"][:8]
        assert h2c.iso_map(h2c.map_to_curve_sswu(us)) == [pt(v["Q0"]),
                                                          pt(v["Q1"])]
        assert h2c.hash_to_curve([msg], dst) == [pt(v["P"])]


def test_reference_map_lands_on_e_prime_both_ways():
    """Seeded u, 0 and p - 1: each (x', y') on E', sgn0(y') = sgn0(u),
    and both of step 7's branches taken."""
    rng = np.random.default_rng(5)
    us = [0, 1, h2c.P - 1] + [int.from_bytes(rng.bytes(48), "big") % h2c.P
                              for _ in range(61)]
    branches = set()
    for u, (x, y) in zip(us, h2c.map_to_curve_sswu(us)):
        assert (y * y - x ** 3 - h2c.A_PRIME * x - h2c.B_PRIME) % h2c.P == 0
        assert y % 2 == u % 2
        gx1_x = h2c._MINUS_B_OVER_A * (1 + h2c._inv0_all(
            [h2c.Z ** 2 * u ** 4 + h2c.Z * u * u])[0]) % h2c.P
        branches.add(x == gx1_x)
    assert branches == {True, False}


@pytest.mark.parametrize("name", ["expand_message_xmd_SHA256_38.json",
                                  "expand_message_xmd_SHA256_256.json"])
def test_reference_expand_vectors(name):
    data = _vectors(name)
    dst = data["DST"].encode()
    for v in data["tests"]:
        assert h2c.expand_message_xmd(
            v["msg"].encode(), dst, int(v["len_in_bytes"], 0)).hex() == \
            v["uniform_bytes"]


def test_reference_points_on_the_curve_and_the_same_across_workers():
    cell = _cell()
    rows = np.concatenate([b.msgs for b in cell.ring])
    lens = np.concatenate([b.lens for b in cell.ring])
    one = h2c.points(rows, lens, cell.dst, 1)
    two = h2c.points(rows, lens, cell.dst, 2)
    assert np.array_equal(one[0], two[0]) and np.array_equal(one[1], two[1])
    assert not one[1].any()
    for row in one[0]:
        x = int.from_bytes(row[:32].tobytes(), "big")
        y = int.from_bytes(row[32:].tobytes(), "big")
        assert (y * y - x ** 3 - 7) % curve.P == 0


def test_reference_maps_zero_denominators_to_the_identity():
    """The isogeny's pole (x_den = 0) and a sum to the identity."""
    pole = 0x89291c84de3e11f1041da6957255eed5fc964a4df050df221d6ad4ce6ab9c5a5
    assert h2c.iso_map([(pole, 5), (1, 2)])[0] is None
    q = h2c.iso_map(h2c.map_to_curve_sswu([7]))[0]
    assert curve.add(q, curve.neg(q)) is None
    assert h2c._inv0_all([0, 2, h2c.P]) == [0, (h2c.P + 1) // 2, 0]


# -- the traffic ------------------------------------------------------------

def test_ring_at_full_size():
    """65,536 lanes a batch, four batches: lengths 0-128 evenly (each
    length's share within 20 % of 1/129), 1,024 lanes of 517 bytes and
    the five vectors in every batch, zero padding, and every message of 2
    bytes or more distinct across the ring."""
    cs = harness.load_cell(ROOT, WORKLOAD)
    cell = _cell(cs)
    planted = [m.encode() for m in cs.mix["planted"]]
    assert len(cell.ring) == 4
    seen, rest = [], []
    for b in cell.ring:
        assert b.msgs.shape == (65536, 517) and b.lens.dtype == np.int32
        assert len(b.long_lanes) == 1024 and len(b.planted) == 5
        assert not set(b.long_lanes.tolist()) & set(b.planted.tolist())
        assert (b.lens[b.long_lanes] == 517).all()
        for lane, m in zip(b.planted, planted):
            assert b.msgs[lane, :b.lens[lane]].tobytes() == m
        assert not (b.msgs * (np.arange(517) >= b.lens[:, None])).any()
        other = np.ones(65536, bool)
        other[b.long_lanes] = other[b.planted] = False
        counts = np.bincount(b.lens[other], minlength=129)
        assert counts.shape == (129,)
        assert (abs(counts / other.sum() * 129 - 1) < 0.2).all()
        keep = np.ones(65536, bool)
        keep[b.planted] = False
        keep &= b.lens >= 2
        seen.append(b.msgs[keep])
        rest.append(b.lens[keep])
    rows = np.concatenate(seen)
    lens = np.concatenate(rest).astype("<i4").view(np.uint8).reshape(-1, 4)
    keyed = np.concatenate([rows, lens], axis=1)
    assert np.unique(keyed, axis=0).shape[0] == keyed.shape[0]


def test_ring_deterministic_by_seed():
    a, b, c = _cell(), _cell(), _cell(seed=SEED + 1)
    for x, y, z in zip(a.ring, b.ring, c.ring):
        assert np.array_equal(x.msgs, y.msgs)
        assert np.array_equal(x.lens, y.lens)
        assert not np.array_equal(x.msgs, z.msgs)


# -- the cell through the program's plain path -------------------------------

def _run(cs, trace=False, seconds=0.05):
    return harness.run_cell(cs, SEED, seconds, trace, "cpu",
                            time.perf_counter(), log=sys.stderr)


def test_untraced_run_is_correct():
    res = _run(tiny())
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["point_mismatches"]["value"] == 0
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}


def test_harness_catches_an_altered_point(monkeypatch):
    from secp256k1_tpu_torch.models import h2c as ph2c
    orig = ph2c.hash_to_curve_batch_arrays

    def altered(msgs, dst, lens=None, device=None):
        pts, ident = orig(msgs, dst, lens, device=device)
        pts[0, 63] ^= 1
        return pts, ident
    monkeypatch.setattr(ph2c, "hash_to_curve_batch_arrays", altered)
    res = _run(tiny())
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["point_mismatches"]["value"] > 0


def test_control_differs_on_every_lane_shorter_than_its_row():
    cell = _cell()
    cell.bind("cpu")
    for b, want in zip(cell.ring, cell.expected()):
        got = cell.call(b)
        assert cell.mismatches(want, got) == 0
        assert got.host_blocks == sum(-(-(126 + int(n)) // 64) + 6
                                      for n in b.lens)
        ctrl = cell.control(b)
        differ = [i for i in range(b.ops)
                  if (ctrl.points[i] != want[0][i]).any()]
        assert differ == [i for i in range(b.ops) if b.lens[i] < 517]
        assert cell.mismatches(want, ctrl) == len(differ) > 0


def test_readers_on_a_made_up_run():
    """None without spans or answers; on two span-timed calls, the
    expansion's summed host spans, the map's device span, the call less
    it, the counter over the lanes; the accepted readers by base name."""
    cell = _cell()
    run = harness.Run(cell, 0.0)

    def read(name):
        return harness.load_module(harness.metric_path(name)).read(run)
    names = ("h2c_expand_ms.ro", "h2c_map_ms.ro", "h2c_host_ms.ro",
             "xmd_host_blocks.ro", "device_idle_pct.h2c",
             "device_ops_per_call.h2c")
    assert all(read(n) is None for n in names)
    mod = harness.load_module(harness.load_cell(ROOT, WORKLOAD).entry_path)
    outs = [mod.Hashed(None, None, 150), mod.Hashed(None, None, 170)]
    run.calls = [harness.Call(t, t + 1.0, t % 2, "spans", outs[t], None)
                 for t in (0, 1)]
    assert read("h2c_map_ms.ro") is None
    run.spans = {
        "h2c.expand_message_xmd_batch": [(0.1, 0.4, None), (1.1, 1.3, None)],
        "h2c._ro_bytes_core": [(0.5, 0.6, 20.0), (1.5, 1.6, 30.0)]}
    assert read("h2c_expand_ms.ro") == pytest.approx(250.0)
    assert read("h2c_map_ms.ro") == pytest.approx(25.0)
    assert read("h2c_host_ms.ro") == pytest.approx(975.0)
    assert read("xmd_host_blocks.ro") == pytest.approx(320 / 32)
    run.profiled_calls = run.calls[:1]
    run.profile = {"window": (0.0, 100.0), "notes": [],
                   "ops": [("k_mod_pow_chain", 0.0, 10.0), ("x", 20.0, 30.0)]}
    assert read("device_idle_pct.h2c") == pytest.approx(80.0)
    assert read("device_ops_per_call.h2c") == 2.0


def test_program_without_lengths_fails_at_bind(monkeypatch):
    """The parent of the lengths: the cell stops at `bind`, before any
    call."""
    from secp256k1_tpu_torch.models import h2c as ph2c

    def no_lens(msgs, dst, device=None):
        raise AssertionError("never called")
    monkeypatch.setattr(ph2c, "hash_to_curve_batch_arrays", no_lens)
    with pytest.raises(TypeError, match="lens"):
        _cell().bind("cpu")


@pytest.mark.card
@pytest.mark.parametrize("seed", (2**31 + 21, 2**31 + 22))
def test_cell_and_control_on_card(card, seed):
    """The cell's traced run on the card reports every new metric and is
    correct; the control at the cell's own size differs."""
    import control
    cs = harness.load_cell(ROOT, WORKLOAD)
    res = harness.run_cell(cs, seed, 4.0, True, card, time.perf_counter(),
                           log=sys.stderr)
    assert res["correct"] and res["failed"] == 0
    assert {m["name"] for m in cs.per_layer} <= set(res["metrics"])
    r = control.readings(cs, seed, card)
    assert r["program"] == 0 and r["control"] > 0
