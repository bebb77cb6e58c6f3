"""The `verify.taproot` cell's own tests, on the CPU (`python -m pytest
benchmark/`): the seeded ring (every lane distinct, every kind of lane
where the traffic puts it), the Taproot reference against a direct
BIP-0340 check and across worker processes, the cell through the
program's plain path at a tiny size (whole, broken underneath, and its
control lane by lane), its metric readers on a made-up record, and its
failure at `bind` on a program without the Taproot check.  On a card
(`-m card`), the control at the cell's own size."""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import pytest

import harness
import yardstick
from reference import curve, taproot
from test_bench_harness import ROOT, SEED

WORKLOAD = "verify.taproot"


def tiny() -> harness.CellSpec:
    cs = harness.load_cell(ROOT, WORKLOAD)
    cs.mix.update(lanes=64, ring=2, corrupt_share=5 / 64,
                  explicit_hashtype_share=4 / 64)
    return cs


def _cell(cs=None, seed=SEED):
    cs = cs or tiny()
    return harness.load_module(cs.entry_path).Cell(cs.config, cs.mix, seed)


def _columns(cell):
    return [np.concatenate([getattr(b, f) for b in cell.ring])
            for f in ("pubs", "digests", "sigs", "lens")]


def test_cell_as_declared():
    cs = harness.load_cell(ROOT, WORKLOAD)
    assert cs.chips == 1 and cs.config["reduced"] == {}
    assert cs.mix["lanes"] == 16384 and cs.mix["ring"] == 4
    assert cs.mix["corrupt_share"] == 1 / 1024
    assert cs.mix["explicit_hashtype_share"] == 1 / 64
    assert cs.config["sig_row_bytes"] == 65
    assert {m["name"] for m in cs.per_layer} == {
        "taproot_host_ms.taproot", "challenge_hash_ms.taproot",
        "schnorr_core_ms.taproot", "glv_signed_roofline.taproot",
        "device_idle_pct.taproot", "device_ops_per_call.taproot"}
    assert {m["name"] for m in cs.end_to_end} == {"ops_per_s", "setup_s"}


def test_every_lane_of_the_ring_distinct_at_full_size():
    """The cell's own traffic: 65,536 (key, digest, signature, length)
    rows, no two alike, and no two keys alike."""
    cell = _cell(harness.load_cell(ROOT, WORKLOAD))
    pubs, digests, sigs, lens = _columns(cell)
    assert pubs.shape[0] == 65536
    rows = np.concatenate([pubs, digests, sigs,
                           lens.astype("<i4").view(np.uint8).reshape(-1, 4)],
                          axis=1)
    assert np.unique(rows, axis=0).shape[0] == rows.shape[0]
    assert np.unique(pubs, axis=0).shape[0] == pubs.shape[0]
    for b in cell.ring:
        assert sum(len(v) for v in b.corrupted.values()) == 15
        assert len(b.explicit) == 256
        assert set(b.sigs[b.explicit, 64]) == set(taproot.HASH_TYPES)


def test_traffic_deterministic_by_seed_and_kinds_in_place():
    a, b, c = _cell(), _cell(), _cell(seed=SEED + 1)
    for x, y, z in zip(a.ring, b.ring, c.ring):
        for f in ("pubs", "digests", "sigs", "lens"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
        assert not np.array_equal(x.pubs, z.pubs)
    for bt in a.ring:
        lanes = np.concatenate(list(bt.corrupted.values()) + [bt.explicit])
        assert len(set(lanes.tolist())) == len(lanes)
        assert set(bt.lens[bt.corrupted["size"]]) <= {63, 66}
        assert (bt.lens[bt.corrupted["hashtype"]] == 65).all()
        assert set(bt.sigs[bt.corrupted["hashtype"], 64]) <= {0, 4, 0x80,
                                                              0x84}
        assert all(int.from_bytes(bt.sigs[i, 32:64].tobytes(), "big")
                   >= curve.N for i in bt.corrupted["s"])


def _direct(pub: bytes, digest: bytes, sig: bytes, length: int) -> int:
    """Core's rules and BIP-0340 verify as the BIP writes it: lift, the
    challenge by hashlib, s G - e P multiplied out."""
    if length not in (64, 65):
        return 1
    if length == 65 and sig[64] not in (1, 2, 3, 0x81, 0x82, 0x83):
        return 12
    key = curve.lift_x(int.from_bytes(pub, "big"), False)
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    if key is None or r >= curve.P or s >= curve.N:
        return 7
    tag = hashlib.sha256(b"BIP0340/challenge").digest()
    e = int.from_bytes(hashlib.sha256(tag + tag + sig[:32] + pub
                                      + digest).digest(), "big") % curve.N
    big_r = curve.add(curve.mul(s, curve.G), curve.mul(curve.N - e, key))
    if big_r is None or big_r[1] % 2 or big_r[0] != r:
        return 7
    return 0


def test_reference_agrees_with_a_direct_check():
    """Every corrupted and explicit lane of the tiny ring and some plain
    ones: the reference (known logs, on the comb) against the direct
    check."""
    cell = _cell()
    want = cell.expected()
    rows = 0
    for b, st in zip(cell.ring, want):
        lanes = np.concatenate(list(b.corrupted.values())
                               + [b.explicit, np.arange(8)])
        for i in lanes:
            assert st[i] == _direct(b.pubs[i].tobytes(),
                                    b.digests[i].tobytes(),
                                    b.sigs[i].tobytes(), int(b.lens[i])), i
            rows += 1
    assert rows >= 24
    codes = {"size": 1, "hashtype": 12, "key": 7, "digest": 7, "s": 7}
    for b, st in zip(cell.ring, want):
        bad = np.zeros(b.ops, bool)
        for kind, lanes in b.corrupted.items():
            assert (st[lanes] == codes[kind]).all()
            bad[lanes] = True
        assert (st[~bad] == 0).all()


def test_reference_is_the_same_across_workers():
    cell = _cell()
    cols = _columns(cell)
    one = taproot.statuses(*cols, cell.pool.key_logs, cell.comb, 1)
    two = taproot.statuses(*cols, cell.pool.key_logs, None, 2)
    assert np.array_equal(one, two) and set(one.tolist()) == {0, 1, 7, 12}


def _run(cs, trace=False, seconds=0.05):
    return harness.run_cell(cs, SEED, seconds, trace, "cpu",
                            time.perf_counter(), log=sys.stderr)


def test_untraced_run_is_correct():
    res = _run(tiny())
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["status_mismatches"]["value"] == 0
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}


def test_harness_catches_altered_statuses(monkeypatch):
    from secp256k1_tpu_torch.models import bitcoin
    orig = bitcoin.verify_taproot_batch_arrays

    def altered(*args, **kw):
        st = orig(*args, **kw)
        st[0] = 7 if st[0] == 0 else 0
        return st
    monkeypatch.setattr(bitcoin, "verify_taproot_batch_arrays", altered)
    res = _run(tiny())
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["status_mismatches"]["value"] > 0


def test_control_differs_exactly_on_the_hashtype_lanes():
    cell = _cell()
    cell.bind("cpu")
    for b, want in zip(cell.ring, cell.expected()):
        assert np.array_equal(cell.call(b), want)
        differ = np.nonzero(cell.control(b) != want)[0]
        assert sorted(differ.tolist()) == sorted(
            b.corrupted["hashtype"].tolist())


def test_readers_on_a_made_up_run():
    """The new readers: None without spans; on two span-timed calls, the
    host share less the core's device span, the summed hash spans and the
    core's mean device span; the suffixed readers of the accepted
    metrics through their base names."""
    cell = _cell()
    run = harness.Run(cell, 0.0)

    def read(name):
        return harness.load_module(harness.metric_path(name)).read(run)
    names = ("taproot_host_ms.taproot", "challenge_hash_ms.taproot",
             "schnorr_core_ms.taproot", "glv_signed_roofline.taproot",
             "device_idle_pct.taproot", "device_ops_per_call.taproot")
    assert all(read(n) is None for n in names)
    run.calls = [harness.Call(t, t + 1.0, t % 2, "spans", None, None)
                 for t in (0, 1)]
    assert all(read(n) is None for n in names)
    run.spans = {
        "native.tagged_hash_batch": [(0.1, 0.12, None), (1.1, 1.13, None)],
        "schnorr._schnorr_verify_e2e_core": [(0.2, 0.3, 20.0),
                                             (1.2, 1.3, 30.0)]}
    assert read("challenge_hash_ms.taproot") == pytest.approx(25.0)
    assert read("schnorr_core_ms.taproot") == pytest.approx(25.0)
    assert read("taproot_host_ms.taproot") == pytest.approx(975.0)
    run.profiled_calls = run.calls[:1]
    run.int_rate = yardstick.int_rate(132, 1980)
    run.profile = {"window": (0.0, 100.0), "notes": [],
                   "ops": [("k_glv_signed", 0.0, 10.0), ("x", 20.0, 30.0)]}
    bound = yardstick.bound_ms(run.int_rate,
                               *yardstick.glv_signed_work(64))[0]
    assert read("glv_signed_roofline.taproot") == pytest.approx(
        100 * bound / 0.01)
    assert read("device_idle_pct.taproot") == pytest.approx(80.0)
    assert read("device_ops_per_call.taproot") == 2.0


def test_program_without_the_check_fails_at_bind(monkeypatch):
    """The parent of the Taproot check: the cell stops at `bind`, before
    any call."""
    from secp256k1_tpu_torch.models import bitcoin
    monkeypatch.delattr(bitcoin, "verify_taproot_batch_arrays")
    with pytest.raises(AttributeError, match="verify_taproot"):
        _cell().bind("cpu")


@pytest.mark.card
@pytest.mark.parametrize("seed", (2**31 + 11, 2**31 + 12, 2**31 + 13))
def test_control_fails_on_card(card, seed):
    import control
    r = control.readings(harness.load_cell(ROOT, WORKLOAD), seed, card)
    assert r["program"] == 0 and r["control"] > 0
