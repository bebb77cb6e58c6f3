"""The port's public surface and the helpers the JAX tests call, on the CPU.

- The package exports every name of `secp256k1_tpu/__init__.py` and its
  version; importing it pulls in no `jax` and starts no process (nothing
  is built at import).
- `ModRing.pow_const` against python `pow` (the edge values of
  `tests/test_kernel_bodies.py`, exponents whose chains fit the chain
  kernel and ones split into parts); against the JAX `pow_const` in a
  `slow` test, with `product_lanes` (each several seconds of eager JAX
  compiles).
- `sum_lanes` and `product_lanes` at odd and even widths against python
  ints, `sum_lanes` also against the JAX function.
- `point.debug_randomize_z` keeps the point; `bytes_are_canonical` against
  the JAX function at m - 1, m and 2^256 - 1; `split_uncompressed_point`.
- `utils/profiling`: `trace` writes a Chrome trace, `timed_chain` times a
  known sleep, `roofline_report` gives the H100 bound of `PERF.md` §6 row
  10 (`point_add`, 65,536 lanes: 0.0113 ms, bytes) and row 11, and
  `chip_smoke.py` takes its yardstick from that module.

Tolerance 0: results are bit-exact.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import gold
import secp256k1_tpu
import secp256k1_tpu_torch
from secp256k1_tpu.ops import limbs as jlb
from secp256k1_tpu.ops.field import F as JF
from secp256k1_tpu.ops.scalar import S as JS
from secp256k1_tpu_torch.models import keys
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import modring
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import scalar as sc
from secp256k1_tpu_torch.utils import hostcurve as hc
from secp256k1_tpu_torch.utils import profiling

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = random.Random(5150)
RINGS = [(fe.F, JF, gold.P), (sc.S, JS, gold.N)]
RING_IDS = ["p", "n"]
EXPORTS = ("bitcoin", "codecs", "ecdh", "ecdsa", "h2c", "keys", "schnorr",
           "PrivateKey", "PublicKey", "generate_key", "RFC6979SHA256",
           "SchnorrPrivateKey", "SchnorrPublicKey", "BatchConfig",
           "ECDSAOptions", "SignatureEncoding")


@pytest.fixture(autouse=True)
def _no_autograd():
    with torch.inference_mode():
        yield


def _edge(m):
    return [0, 1, 2, m - 1, m - 2, 2**255 % m, (m >> 1) + 1]


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=lb.DTYPE)


def _ints(x):
    return lb.limbs_to_int_batch(x)


def _byte_rows(vals):
    return np.stack([np.frombuffer(v.to_bytes(32, "big"), dtype=np.uint8)
                     for v in vals], axis=-1)


def test_exports_match_the_jax_package():
    for name in EXPORTS:
        assert hasattr(secp256k1_tpu, name), name
        assert hasattr(secp256k1_tpu_torch, name), name
    assert secp256k1_tpu_torch.__version__ == secp256k1_tpu.__version__
    assert secp256k1_tpu_torch.ecdsa.__name__ == \
        "secp256k1_tpu_torch.models.ecdsa"
    assert secp256k1_tpu_torch.generate_key is keys.generate_key


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = (
        "import json, subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process started at import')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import secp256k1_tpu_torch as s\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'secp256k1_tpu.')) or m == 'secp256k1_tpu')\n"
        "print(json.dumps([s.__version__, bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["0.1.0", []]


@pytest.mark.parametrize("ring,jring,m", RINGS, ids=RING_IDS)
def test_pow_const_matches_python_pow(ring, jring, m):
    vals = _edge(m) + [RNG.randrange(m) for _ in range(9)]
    x = _plane(vals)
    alternating = int("10" * 128, 2)
    exps = [1, 2, 3, 65537, m - 2, (m - 3) // 4, 2**300 + 1, alternating,
            RNG.getrandbits(256)]
    assert len(modring._chain_parts(alternating)) > 1   # split in parts
    assert modring._chain_parts(m - 2) == [m - 2]       # one launch
    for e in exps:
        assert _ints(ring.pow_const(x, e)) == [pow(v, e, m) for v in vals], e
    with pytest.raises(ValueError, match="e must be >= 1"):
        ring.pow_const(x, 0)


def test_chain_parts_sum_to_the_exponent():
    for e in [int("10" * 128, 2), int("110" * 85, 2), (1 << 256) - 1,
              RNG.getrandbits(512)]:
        parts = modring._chain_parts(e)
        assert sum(parts) == e and all(p & q == 0 for p in parts
                                       for q in parts if p is not q)


@pytest.mark.parametrize("width", [7, 8])
@pytest.mark.parametrize("ring,jring,m", RINGS, ids=RING_IDS)
def test_sum_and_product_lanes(ring, jring, m, width):
    vals = _edge(m)[:width] + [RNG.randrange(m)
                               for _ in range(width - len(_edge(m)))]
    x = _plane(vals)
    got_sum = ring.sum_lanes(x)
    got_prod = ring.product_lanes(x[:, 1:])             # no zero lane
    assert got_sum.shape == got_prod.shape == (16, 1)
    assert _ints(got_sum) == [sum(vals) % m]
    want = 1
    for v in vals[1:]:
        want = want * v % m
    assert _ints(got_prod) == [want]
    jx = np.asarray(jlb.int_to_limbs_batch(vals))
    assert jlb.limbs_to_int_batch(np.asarray(jring.sum_lanes(jx))) == \
        _ints(got_sum)


@pytest.mark.slow
@pytest.mark.parametrize("ring,jring,m", RINGS, ids=RING_IDS)
def test_pow_const_and_product_lanes_match_jax(ring, jring, m):
    vals = _edge(m) + [RNG.randrange(1, m) for _ in range(8)]
    x = _plane(vals)
    jx = np.asarray(jlb.int_to_limbs_batch(vals))
    for e in (1, 3, 65537):
        assert _ints(ring.pow_const(x, e)) == jlb.limbs_to_int_batch(
            np.asarray(jring.pow_const(jx, e)))
    assert _ints(ring.product_lanes(x)) == jlb.limbs_to_int_batch(
        np.asarray(jring.product_lanes(jx)))


def test_debug_randomize_z_keeps_the_point():
    pts = [gold.affine_mul(RNG.randrange(1, gold.N), gold.GEN)
           for _ in range(4)]
    p = pt.from_affine_ints(pts, device="cpu")
    zs = _plane([RNG.randrange(1, gold.P) for _ in range(3)] + [gold.P - 1])
    p2 = pt.debug_randomize_z(p, zs)
    assert not torch.equal(p2.z, p.z)
    assert pt.equal(p, p2).all() and pt.on_curve(p2).all()
    aff = pt.to_affine(p2)
    assert list(zip(_ints(aff.x), _ints(aff.y))) == pts


@pytest.mark.parametrize("ring,jring,m", RINGS, ids=RING_IDS)
def test_bytes_are_canonical_matches_jax(ring, jring, m):
    vals = [0, 1, m - 1, m, m + 1, 2**256 - 1, RNG.randrange(m),
            RNG.randrange(m, 2**256)]
    byts = _byte_rows(vals)
    got = ring.bytes_are_canonical(torch.as_tensor(byts)).tolist()
    assert got == [v < m for v in vals]
    assert got == np.asarray(jring.bytes_are_canonical(byts)).tolist()


def test_split_uncompressed_point():
    pub = keys.PrivateKey(0xC0FFEE).public_key
    xb, odd = hc.split_uncompressed_point(pub.bytes())
    assert xb == pub.point[0].to_bytes(32, "big")
    assert odd == bool(pub.point[1] & 1)
    for bad in (pub.compressed_bytes(), b"\x02" + pub.bytes()[1:],
                pub.bytes()[:64]):
        with pytest.raises(ValueError, match="invalid uncompressed point"):
            hc.split_uncompressed_point(bad)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = _plane([3, 5])
    with profiling.trace(str(tmp_path)) as log_dir:
        fe.F.mul(a, a)
    assert log_dir == str(tmp_path)
    with open(tmp_path / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in ev.get("name", "") for ev in events)


def test_timed_chain_takes_the_slope():
    def fn(s):
        time.sleep(s)
    per_call = profiling.timed_chain(fn, (0.01,), n_reps_small=1,
                                     n_reps_big=3, reps=2)
    assert 0.009 < per_call < 0.05


@pytest.mark.parametrize("op,bound_ms", [("point_add", 0.0113),
                                         ("point_double", 0.0075)])
def test_roofline_report_gives_the_h100_bound(op, bound_ms):
    rep = profiling.roofline_report(65536, 0.0221e-3, op, sm_count=132,
                                    sm_clock_mhz=1980)
    assert rep["op"] == op and rep["lanes"] == 65536
    assert round(rep["bound_s"] * 1e3, 4) == bound_ms
    assert rep["bound_by"] == "bytes"
    assert rep["bound_s"] == rep["memory_bound_s"] > rep["compute_bound_s"]
    assert rep["pct_of_compute_roofline"] == round(
        100 * rep["compute_bound_s"] / 0.0221e-3, 1)
    products = {"point_add": profiling.PT_ADD,
                "point_double": profiling.PT_DOUBLE}[op]
    assert rep["compute_bound_s"] == 65536 * products / (132 * 64 * 1.98e9)


def test_chip_smoke_takes_its_yardstick_from_profiling():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    for name in ("MUL_P", "SQR_P", "MUL_N", "SQR_N",
                 "MULW_P", "PT_ADD", "PT_ADD_MIXED", "PT_DOUBLE",
                 "bound_terms", "bound_ms", "int8_rate"):
        assert getattr(chip_smoke, name) is getattr(profiling, name), name
