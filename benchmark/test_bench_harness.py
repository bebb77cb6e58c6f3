"""The benchmark's own tests, on the CPU (`python -m pytest benchmark/`):
the files found by name, the seeded traffic, the reference against known
vectors, the import check, BENCHMARK.json's names, and runs of the harness
through the program's plain path at a tiny size, whole and with the timed
path broken underneath."""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import time

import numpy as np
import pytest

import harness
import tracing
import yardstick
from reference import consensus, curve, msm

ROOT = os.path.dirname(harness.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
SEED = 2**31 + 977


def tiny(workload: str) -> harness.CellSpec:
    """The cell with a pool and ring small enough for the plain path."""
    cs = harness.load_cell(ROOT, workload)
    if cs.config["entry"] == "consensus_verify":
        cs.config["distinct_triples"] = 16
        cs.mix.update(lanes=32, ring=2, corrupt_share=0.25)
    else:
        cs.config["distinct_points"] = 8
        cs.mix.update(lanes=16, ring=2)
    return cs


def make(cs, seed=SEED):
    return harness.load_module(cs.entry_path).Cell(cs.config, cs.mix, seed)


# -- files found by name, names and units ----------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cs = harness.load_cell(ROOT, workload)
    mod = harness.load_module(cs.entry_path)
    for attr in ("Cell", "SPANS", "CHECK"):
        assert hasattr(mod, attr)
    names = [m["name"] for m in cs.end_to_end + cs.per_layer]
    assert "setup_s" in names and len(cs.end_to_end) >= 2 and cs.per_layer
    for name in names:
        reader = harness.load_module(harness.metric_path(name))
        assert callable(reader.read)


def test_metric_reader_falls_back_to_its_base_name():
    metrics = os.path.join(harness.HERE, "metrics")
    assert harness.metric_path("setup_s") == os.path.join(metrics,
                                                          "setup_s.py")
    assert harness.metric_path("device_idle_pct.some_new_cell") == \
        os.path.join(metrics, "device_idle_pct.py")
    missing = harness.metric_path("no_such_metric.cell")
    assert not os.path.exists(missing)
    with pytest.raises(FileNotFoundError):
        harness.load_module(missing)


def test_benchmark_json_names_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and TEXT.fullmatch(c["source"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert set(c["reduced"]) == set(conf["reduced"])
        assert conf["name"] == c["name"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.fullmatch(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", WORKLOADS)
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in WORKLOADS:
        cs = harness.load_cell(ROOT, w)
        assert len(cs.end_to_end) >= 2 and cs.per_layer


# -- the reference ----------------------------------------------------------

def test_curve_known_multiples():
    comb = curve.Comb()
    two, three = comb.mul_batch([2, 3])
    assert two == curve.add(curve.G, curve.G) == (
        0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5,
        0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A)
    assert three[0] == \
        0xF9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9
    assert comb.mul_batch([curve.N - 1])[0] == curve.neg(curve.G)
    assert comb.mul_batch([0, curve.N])[0] is None


BIP66_VALID = [
    "3044022029db2d5f4e1dcc04e19266cce3cb135865784c62ab653b307f0e0bb744f5c2"
    "aa022000a97f5826912cac8b44d9f577a26f169a2f8db781f2ddb7de2bc886e93b6844",
    "304302201ea1fdff81b3a271659df4aad19bc4ef83def389131a36358fe64b245632e7"
    "77021f29e164658be9ce810921bf81d6b86694785a79ea1e52dbfa5105148d1f0bc1",
]
BIP66_INVALID = [
    "ffffffffffffff", "00ffff0400ffffff020400ffffff",
    "30ff020400ffffff020400ffffff", "300c030400ffffff030400ffffff0000",
    "300cff0400ffffff020400ffffff", "300c020200ffffff020400ffffff",
    "30080200020400ffffff", "3008020400ffffff0200",
    "300c02dd00ffffff020400ffffff", "300c020400ffffff02dd00ffffff",
    "300c020480000000020400ffffff",
]


@pytest.mark.parametrize("der,ok", [(d, True) for d in BIP66_VALID]
                         + [(d, False) for d in BIP66_INVALID])
def test_bip66_vectors(der, ok):
    sig = bytes.fromhex(der) + b"\x01"
    assert consensus.bip66_valid(sig) is ok


# RFC 6979 vector (key 1, bitcointalk topic 285142): a low-s signature by
# the key G of SHA-256("Absence makes the heart grow fonder.").
KAT_MSG = b"Absence makes the heart grow fonder."
KAT_DER = ("3045022100AFFF580595971B8C1700E77069D73602AEF4C2A760DBD697881423DF"
           "FF845DE80220579ADB6A1AC03ACDE461B5821A049EBD39A8A8EBF2506B841B15C2"
           "7342D2E342")


def _rows(pub: bytes, digest: bytes, sig: bytes):
    row = np.zeros((1, 73), np.uint8)
    row[0, :len(sig)] = np.frombuffer(sig, np.uint8)
    return (np.frombuffer(pub, np.uint8)[None], np.frombuffer(digest,
                                                              np.uint8)[None],
            row, np.array([len(sig)], np.int32))


@pytest.mark.parametrize("case,status", [
    ("good", consensus.OK), ("digest", consensus.ERR_V_NEQ_R),
    ("high_s", consensus.ERR_MALLEABLE),
    ("no_sighash", consensus.ERR_INVALID_ENCODING),
    ("prefix", consensus.ERR_INVALID_PUBLIC_KEY),
    ("x_ge_p", consensus.ERR_INVALID_PUBLIC_KEY),
    ("r_ge_n", consensus.ERR_INVALID_SCALAR),
])
def test_reference_known_signature(case, status):
    """The vector, decoded and multiplied out (no known log), and each
    rule broken once."""
    pub = curve.compressed(curve.G)
    digest = hashlib.sha256(KAT_MSG).digest()
    der = bytes.fromhex(KAT_DER)
    r, s = consensus.parse_der(der)[1:]
    if case == "digest":
        digest = bytes([digest[0] ^ 1]) + digest[1:]
    elif case == "high_s":
        der = consensus.der_signature(r, curve.N - s)
    elif case == "prefix":
        pub = b"\x05" + pub[1:]
    elif case == "x_ge_p":
        pub = pub[:1] + curve.P.to_bytes(32, "big")
    elif case == "r_ge_n":
        der = consensus.der_signature(curve.N + 1, s)
    sig = der if case == "no_sighash" else der + b"\x01"
    got = consensus.statuses(*_rows(pub, digest, sig), {}, curve.Comb())
    assert got.tolist() == [status]


def test_reference_statuses_of_corrupted_lanes():
    cs = tiny("verify.block")
    cell = make(cs)
    want = cell.expected()
    codes = {"bip66": consensus.ERR_INVALID_ENCODING,
             "high_s": consensus.ERR_MALLEABLE,
             "digest": consensus.ERR_V_NEQ_R,
             "off_curve": consensus.ERR_INVALID_PUBLIC_KEY}
    for b, st in zip(cell.ring, want):
        bad = np.zeros(b.ops, bool)
        for kind, lanes in b.corrupted.items():
            assert len(lanes) == 2 and (st[lanes] == codes[kind]).all()
            bad[lanes] = True
        assert (st[~bad] == consensus.OK).all()


def test_reference_msm_sum():
    comb = curve.Comb()
    gen = np.random.default_rng(3)
    logs = [int(v) + 1 for v in gen.integers(1, 2**62, 8)]
    pts = comb.mul_batch(logs)
    src = gen.permutation(np.tile(np.arange(8), 4))
    scalars = gen.integers(0, 256, (32, 32), dtype=np.uint8)
    total = None
    for row, j in zip(scalars, src):
        total = curve.add(total, curve.mul(int.from_bytes(row.tobytes(),
                                                          "big"), pts[j]))
    assert msm.expected_sum(scalars, src, logs, comb) == \
        curve.uncompressed(total)


# -- the traffic ------------------------------------------------------------

@pytest.mark.parametrize("workload", ["verify.block", "msm.bip340_batch"])
def test_traffic_deterministic_by_seed(workload):
    cs = tiny(workload)
    a, b, c = make(cs), make(cs), make(cs, SEED + 1)
    fields = ("pubs", "digests", "sigs", "lens") \
        if hasattr(a.ring[0], "sigs") else ("scalars", "src")
    for f in fields:
        for x, y, z in zip(a.ring, b.ring, c.ring):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    assert any(not np.array_equal(getattr(x, f), getattr(z, f))
               for f in fields for x, z in zip(a.ring, c.ring))
    assert not np.array_equal(getattr(a.ring[0], fields[0]),
                              getattr(a.ring[1], fields[0]))


def test_msm_scalars_below_n():
    mod = harness.load_module(os.path.join(harness.HERE, "entries",
                                           "batch_msm.py"))
    rows = mod.uniform_scalars(np.random.default_rng(0), 4096)
    assert all(int.from_bytes(r.tobytes(), "big") < curve.N for r in rows)


# -- the import check -------------------------------------------------------

def test_import_check_whole_names():
    fake = {"secp256k1_tpu": 0, "secp256k1_tpu.ops.field": 0,
            "secp256k1_tpu_torch": 0, "secp256k1_tpu_torch.ops": 0,
            "jax.numpy": 0, "jaxlib": 0, "jaxtyping": 0, "flax": 0,
            "numpy": 0}
    assert harness.forbidden_modules(fake) == [
        "flax", "jax.numpy", "jaxlib", "secp256k1_tpu",
        "secp256k1_tpu.ops.field"]
    assert harness.forbidden_modules({"secp256k1_tpu_torch.models": 0}) == []


def test_reference_imports_nothing_of_the_program():
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.consensus, reference.msm, yardstick; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))                    # noqa: S307 - our own output
    assert not tops & {"torch", "jax", "secp256k1_tpu",
                       "secp256k1_tpu_torch"}


# -- the trace readers on a made-up profile ---------------------------------

def test_breakdown_and_idle_share():
    prof = {"window": (0.0, 100.0),
            "ops": [("k_a", 10.0, 30.0), ("k_b", 20.0, 40.0),
                    ("Memcpy HtoD", 60.0, 70.0)],
            "notes": [("call", 0.0, 100.0), ("layer.x", 40.0, 60.0)]}
    assert tracing.busy_s(prof) == pytest.approx(40e-6)
    assert tracing.window_s(prof) == pytest.approx(100e-6)
    bd = tracing.breakdown(prof)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "call": pytest.approx(40e-6), "layer.x": pytest.approx(20e-6)}


def test_yardstick_bounds():
    rate = yardstick.int_rate(132, 1980)
    glv = yardstick.bound_ms(rate, *yardstick.glv_signed_work(65536))
    assert glv[1] == "operations" and glv[0] == pytest.approx(0.5492, 1e-3)
    ones = np.full((1 << 20, 32), 0x11, np.uint8)
    b = yardstick.bound_ms(rate, *yardstick.msm_buckets_work(ones))
    assert b[0] == pytest.approx((1 << 26) * yardstick.PT_ADD / rate * 1e3)


# -- the harness through the program's plain path ---------------------------

def _run(cs, seconds=0.05):
    return harness.run_cell(cs, SEED, seconds, False, "cpu",
                            time.perf_counter(), log=sys.stderr)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_harness_run_on_plain_path(workload):
    res = _run(tiny(workload))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   harness.load_cell(ROOT, workload)
                                   .end_to_end}


def _fault_verify(monkeypatch, kind):
    from secp256k1_tpu_torch.models import bitcoin, ecdsa
    if kind == "half":                 # half the lanes left out, OK filled
        orig = bitcoin.verify_asn1_batch_arrays

        def half(pubs, digests, sigs, lens, **kw):
            h = pubs.shape[0] // 2
            st = orig(pubs[:h], digests[:h], sigs[:h], lens[:h], **kw)
            return np.concatenate([st, np.zeros(pubs.shape[0] - h,
                                                np.int32)])
        monkeypatch.setattr(bitcoin, "verify_asn1_batch_arrays", half)
    else:                              # one status altered where produced
        orig = ecdsa._verify_impl

        def altered(*args):
            st = orig(*args).clone()
            st[0] = consensus.ERR_V_NEQ_R if int(st[0]) == 0 else 0
            return st
        monkeypatch.setattr(ecdsa, "_verify_impl", altered)


def _fault_msm(monkeypatch, kind):
    from secp256k1_tpu_torch.ops import msm as pmsm
    from secp256k1_tpu_torch.ops import point as pt
    orig = pmsm.multi_scalar_mult
    if kind == "half":
        def half(k, p, window_bits=None):
            h = k.shape[1] // 2
            return orig(k[:, :h], pt.Point(p.x[:, :h], p.y[:, :h],
                                           p.z[:, :h]), window_bits)
        monkeypatch.setattr(pmsm, "multi_scalar_mult", half)
    else:
        def altered(k, p, window_bits=None):
            s = orig(k, p, window_bits)
            return pt.add(s, pt.Point(p.x[:, :1], p.y[:, :1], p.z[:, :1]))
        monkeypatch.setattr(pmsm, "multi_scalar_mult", altered)


@pytest.mark.parametrize("workload", ["verify.block", "msm.bip340_batch"])
@pytest.mark.parametrize("kind", ["half", "altered"])
def test_harness_catches_broken_path(monkeypatch, workload, kind):
    cs = tiny(workload)
    if cs.config["entry"] == "consensus_verify":
        _fault_verify(monkeypatch, kind)
    else:
        _fault_msm(monkeypatch, kind)
    res = _run(cs)
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"][harness.load_module(cs.entry_path).CHECK][
        "value"] > 0


@pytest.mark.parametrize("workload", ["verify.block", "msm.bip340_batch"])
def test_control_fails(workload):
    import control
    r = control.readings(tiny(workload), SEED, "cpu")
    assert r["program"] == 0 and r["control"] > 0
