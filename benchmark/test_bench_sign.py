"""The `sign.custody` cell's own tests, on the CPU (`python -m pytest
benchmark/`): the wallet-signing reference against the RFC 6979 vectors and
across worker processes, the #6 yardstick, the cell through the program's
plain path at a tiny size (whole, broken underneath, and its control), its
metric readers on a made-up record, and its failure at `bind` on a program
without the signer."""

from __future__ import annotations

import hashlib
import subprocess
import sys
import time

import numpy as np
import pytest

import harness
import yardstick
import yardstick_sign
from reference import curve, wallet_sign
from test_bench_harness import KAT_DER, KAT_MSG, ROOT, SEED, tiny

WORKLOAD = "sign.custody"


def _cell(cs=None, seed=SEED):
    cs = cs or tiny(WORKLOAD)
    return harness.load_module(cs.entry_path).Cell(cs.config, cs.mix, seed)


def test_reference_signs_the_vector_and_grinds_it():
    """Key 1's vector has a high r (0xAF...): ungrounded it is the vector;
    ground, the next attempt is low and verifies."""
    digest = hashlib.sha256(KAT_MSG).digest()
    want = bytes.fromhex(KAT_DER) + b"\x01"
    rows, attempts = wallet_sign.sign_lanes([1], [digest], 1, False)
    assert rows == [want] and attempts == [1]
    rows, attempts = wallet_sign.sign_lanes([1], [digest], 1, True)
    assert attempts[0] >= 2 and rows[0] != want
    assert rows[0][3] <= 32 and len(rows[0]) <= 71


def test_reference_is_the_same_across_workers():
    cell = _cell()
    b = cell.ring[0]
    keys = [int.from_bytes(r.tobytes(), "big") for r in b.priv]
    digests = [r.tobytes() for r in b.digests]
    one = wallet_sign.sign(keys, digests, 1, True, workers=1)
    two = wallet_sign.sign(keys, digests, 1, True, workers=2)
    assert one == two and max(one[1]) >= 2


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.wallet_sign, yardstick_sign; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))                    # noqa: S307 - our own output
    assert not tops & {"torch", "jax", "secp256k1_tpu",
                       "secp256k1_tpu_torch"}


def test_base_scan_yardstick_at_its_bound():
    rate = yardstick.int_rate(132, 1980)
    ms, by = yardstick.bound_ms(rate, *yardstick_sign.base_scan_work(65536))
    assert by == "operations" and ms == pytest.approx(0.1052, 1e-3)


def test_keys_distinct_below_n_and_deterministic():
    cs = tiny(WORKLOAD)
    cs.mix.update(lanes=4096)
    a, b, c = _cell(cs), _cell(cs), _cell(cs, SEED + 1)
    keys = np.concatenate([x.priv for x in a.ring])
    assert np.unique(keys, axis=0).shape[0] == keys.shape[0]
    assert all(0 < int.from_bytes(r.tobytes(), "big") < curve.N
               for r in keys)
    for x, y, z in zip(a.ring, b.ring, c.ring):
        assert np.array_equal(x.priv, y.priv)
        assert np.array_equal(x.digests, y.digests)
        assert not np.array_equal(x.priv, z.priv)


def _run(cs, trace=False, seconds=0.05):
    return harness.run_cell(cs, SEED, seconds, trace, "cpu",
                            time.perf_counter(), log=sys.stderr)


def test_readers_on_a_made_up_run():
    """The new readers on a record of two span-timed calls: counters from
    the calls' answers, spans summed within each call, the roofline from
    the lanes the reference attempted; None where nothing was recorded."""
    mod = harness.load_module(tiny(WORKLOAD).entry_path)
    cell = _cell()
    run = harness.Run(cell, 0.0)

    def read(name):
        return harness.load_module(harness.metric_path(name)).read(run)
    assert read("grind_rounds.custody") is None
    assert read("sign_nonce_ms.custody") is None
    none = np.zeros(0)
    run.calls = [harness.Call(t, t + 1.0, t % 2, "spans",
                              mod.Signed(none, none, none, r, q), None)
                 for t, r, q in ((0, 5, 30), (1, 7, 34))]
    run.spans = {
        "native.rfc6979_nonce_batch": [(0.1, 0.2, None), (0.5, 0.6, None),
                                       (1.1, 1.4, None)],
        "ecdsa._sign_e2e_core": [(0.2, 0.3, 2.0), (0.6, 0.7, 3.0),
                                 (1.4, 1.5, 4.0)]}
    assert read("grind_rounds.custody") == 6.0
    assert read("nonces_per_sig.custody") == 64 / 32
    assert read("sign_nonce_ms.custody") == pytest.approx(250.0)
    assert read("sign_core_ms.custody") == pytest.approx(4.5)
    assert read("base_scan_roofline") is None
    run.profiled_calls = run.calls[:1]
    run.int_rate = yardstick.int_rate(132, 1980)
    run.profile = {"window": (0.0, 1e6), "notes": [],
                   "ops": [("k_base_scan", 0.0, 10.0),
                           ("k_base_scan", 20.0, 30.0)]}
    cell.ring[0].attempted = 32
    bound = yardstick.bound_ms(run.int_rate,
                               *yardstick_sign.base_scan_work(32))[0]
    assert read("base_scan_roofline") == pytest.approx(
        100 * bound / 0.02)


def test_untraced_run_is_correct():
    res = _run(tiny(WORKLOAD))
    assert res["correct"] and res["checks"]["sig_mismatches"]["value"] == 0
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_harness_catches_broken_signer(monkeypatch, kind):
    from secp256k1_tpu_torch.models import bitcoin
    orig = bitcoin.sign_der_batch_arrays

    def broken(priv, digests, **kw):
        if kind == "half":
            h = priv.shape[0] // 2
            der, lens, st = orig(priv[:h], digests[:h], **kw)
            pad = priv.shape[0] - h
            return (np.concatenate([der, np.zeros((pad, 72), np.uint8)]),
                    np.concatenate([lens, np.zeros(pad, np.int32)]),
                    np.concatenate([st, np.zeros(pad, np.int32)]))
        der, lens, st = orig(priv, digests, **kw)
        der[0, 8] ^= 1
        return der, lens, st
    monkeypatch.setattr(bitcoin, "sign_der_batch_arrays", broken)
    res = _run(tiny(WORKLOAD))
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["sig_mismatches"]["value"] > 0


def test_control_fails():
    import control
    r = control.readings(tiny(WORKLOAD), SEED, "cpu")
    assert r["program"] == 0 and r["control"] > 0


def test_program_without_the_signer_fails_at_bind(monkeypatch):
    """The parent of the signer: the cell stops at `bind`, before any
    call."""
    from secp256k1_tpu_torch.models import bitcoin
    monkeypatch.delattr(bitcoin, "sign_der_batch_arrays")
    with pytest.raises(AttributeError, match="sign_der_batch_arrays"):
        _cell().bind("cpu")
    assert harness.load_cell(ROOT, WORKLOAD).chips == 1
