"""The port's RFC 9380 hash-to-curve on the CPU.

- the suite vectors (RO and NU) through the list paths, the arrays paths
  and the one-message wrappers on `device="cpu"`;
- `expand_message_xmd` against the RFC vectors, its rejections (empty
  DST, `n_out` > 65535, ell > 255) and the oversize-DST reduction, and
  the native batch form against the JAX package's (hashlib only: no JAX
  pipeline compiles);
- `ModRing.from_wide_bytes` against python ints on strings >= p;
- the map's edge lanes (u = 0, tv2 = 0, u = p - 1, strings >= p) and the
  isogeny's zero denominators against the python-int oracle of
  `h2c_oracle.py`, the RFC's straightforward form (section 6.6.2, not the
  straight-line one the port follows) on the JAX package's constants;
- `slow`: the port's device cores against the JAX package's jitted ones.

Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

import h2c_oracle as oracle
from secp256k1_tpu.models import h2c as jh2c
from secp256k1_tpu_torch.models import h2c
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import swu
from secp256k1_tpu_torch.utils import batching as bt

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
P = fe.P
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
SUITES = {"RO": ("secp256k1_XMD_SHA-256_SSWU_RO_.json",
                 h2c.hash_to_curve_batch, h2c.hash_to_curve_batch_arrays,
                 h2c.hash_to_curve),
          "NU": ("secp256k1_XMD_SHA-256_SSWU_NU_.json",
                 h2c.encode_to_curve_batch, h2c.encode_to_curve_batch_arrays,
                 h2c.encode_to_curve)}
# u with u^2 = 1/11 = -1/Z, where tv2 = Z^2 u^4 + Z u^2 is 0.
U_TV2_ZERO = 0x331716177ec001cf0b2a4b9bf5c63274440235ba3dc0af713237ec866179d785
# The double root of the isogeny's x_den and triple root of its y_den.
X_ISO_POLE = 0x89291c84de3e11f1041da6957255eed5fc964a4df050df221d6ad4ce6ab9c5a5


@pytest.fixture(autouse=True)
def _inference_mode():
    """No autograd bookkeeping: the plain path dispatches many small ops."""
    with torch.inference_mode():
        yield


def _points(planes, n):
    """Projective planes -> affine int pairs (None for Z = 0)."""
    xs, ys, zs = (lb.limbs_to_int_batch(c[:, :n]) for c in planes)
    return [None if z == 0 else (x * oracle.inv0(z) % P,
                                 y * oracle.inv0(z) % P)
            for x, y, z in zip(xs, ys, zs)]


def _wide(vals, width=48):
    return [v.to_bytes(width, "big") for v in vals]


# --- suites --------------------------------------------------------------

@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_suite_vectors(suite):
    """The RFC 9380 vectors through the list path and the one-message
    wrapper; the arrays path on five 32-byte messages against the
    python-int oracle."""
    fname, batch, arrays, one = SUITES[suite]
    with open(os.path.join(TESTDATA, fname)) as f:
        data = json.load(f)
    dst = data["dst"].encode()
    vecs = data["vectors"]
    got = batch([v["msg"].encode() for v in vecs], dst, device=CPU)
    want = [(int(v["P"]["x"], 16), int(v["P"]["y"], 16)) for v in vecs]
    assert got == want
    assert one(vecs[1]["msg"].encode(), dst, device=CPU) == want[1]

    msgs = np.stack([np.frombuffer(bytes([7 * i + 1]) * 32, np.uint8)
                     for i in range(5)])
    pts, ident = arrays(msgs, dst, device=CPU)
    assert pts.shape == (5, 64) and not ident.any()
    for i, m in enumerate(msgs):
        assert (int.from_bytes(pts[i, :32].tobytes(), "big"),
                int.from_bytes(pts[i, 32:].tobytes(), "big")) == \
            oracle.point(m.tobytes(), dst, suite == "RO")


# --- expand_message_xmd --------------------------------------------------

@pytest.mark.parametrize("fname", ["expand_message_xmd_SHA256_38.json",
                                   "expand_message_xmd_SHA256_256.json"])
def test_expand_message_xmd_vectors(fname):
    """The RFC vectors, one message at a time and as batches of one."""
    with open(os.path.join(TESTDATA, fname)) as f:
        data = json.load(f)
    dst = data["DST"].encode()
    for v in data["tests"]:
        n_out = int(v["len_in_bytes"], 0)
        msg = v["msg"].encode()
        assert h2c.expand_message_xmd(msg, dst, n_out).hex() == \
            v["uniform_bytes"], v["msg"][:20]
        row = np.frombuffer(msg, np.uint8)[None, :]
        assert h2c.expand_message_xmd_batch(row, dst, n_out)[0].tobytes() \
            .hex() == v["uniform_bytes"], v["msg"][:20]


def test_expand_message_edge_cases():
    """Empty DST, n_out above 65535 and ell above 255 raise in both forms;
    a 300-byte DST is reduced, as the JAX package reduces it."""
    rows = np.zeros((2, 3), np.uint8)
    # 8161 bytes need ell = 256 blocks of 32; 8160 need 255.
    for dst, n_out in ((b"", 32), (b"d", 70000), (b"d", 8161)):
        with pytest.raises(ValueError):
            h2c.expand_message_xmd(b"m", dst, n_out)
        with pytest.raises(ValueError):
            h2c.expand_message_xmd_batch(rows, dst, n_out)
    out = h2c.expand_message_xmd(b"m", b"d" * 300, 32)
    assert out == jh2c.expand_message_xmd(b"m", b"d" * 300, 32)
    assert len(out) == 32
    assert h2c.expand_message_xmd(b"m", b"d", 8160) == \
        jh2c.expand_message_xmd(b"m", b"d", 8160)


@pytest.mark.parametrize("dst", [b"QUUX-V01-CS02-with-expander-SHA256-128",
                                 b"x" * 300], ids=["dst38", "dst300"])
def test_expand_batch_matches_jax(dst):
    """The native batch form against the JAX package's one-message
    hashlib form, byte for byte."""
    rng = np.random.default_rng(9)
    for length in (0, 24, 65):
        msgs = rng.integers(0, 256, (6, length), dtype=np.uint8)
        for n_out in (32, 48, 96, 128, 255):
            got = h2c.expand_message_xmd_batch(msgs, dst, n_out)
            assert got.shape == (6, n_out)
            for i, m in enumerate(msgs):
                assert got[i].tobytes() == jh2c.expand_message_xmd(
                    m.tobytes(), dst, n_out), (length, n_out, i)


# --- field and map -------------------------------------------------------

def test_from_wide_bytes_reduces_strings_at_or_above_p():
    rng = np.random.default_rng(4)
    rand = [int.from_bytes(rng.bytes(48), "big") for _ in range(6)]
    vals = [0, P - 1, P, P + 1, 2 ** 256, 2 ** 256 + P, 2 ** 384 - 1,
            (2 ** 384 - 1) // P * P, 2 ** 383] + rand
    for width in (48, 64, 33):
        v = [x % (1 << (8 * width)) for x in vals]
        planes = bt.byte_plane(_wide(v, width), len(v), device=CPU)
        got = lb.limbs_to_int_batch(fe.from_wide_bytes(planes))
        assert got == [x % P for x in v], width
    with pytest.raises(ValueError):
        fe.from_wide_bytes(torch.zeros((65, 1), dtype=torch.uint8))


def _edge_uniform():
    """48-byte strings: u = 0 (zeros and p), the tv2 = 0 lane and its
    negation, u = p - 1, u = 1, strings >= p (all 0xFF among them), and
    seeded ones."""
    rng = np.random.default_rng(11)
    vals = [0, P, U_TV2_ZERO, P - U_TV2_ZERO, P - 1, 1, 2 * P + 5,
            2 ** 384 - 1, P + U_TV2_ZERO]
    vals += [int.from_bytes(rng.bytes(48), "big") for _ in range(16 - 9)]
    return _wide(vals)


def test_map_edge_lanes_match_the_python_oracle():
    """SWU on E' lane by lane, and set_uniform_bytes (wide reduction, SWU,
    isogeny, identity on exceptional lanes) on 16 lanes of edge strings."""
    uniform = _edge_uniform()
    planes = bt.byte_plane(uniform, 16, device=CPU)
    u = fe.from_wide_bytes(planes)
    xp, yp = swu.map_to_curve_simple_swu(u)
    want = [oracle.sswu(int.from_bytes(s, "big") % P) for s in uniform]
    assert list(zip(lb.limbs_to_int_batch(xp),
                    lb.limbs_to_int_batch(yp))) == want
    got = swu.set_uniform_bytes(planes)
    want = [oracle.iso(*w) for w in want]
    assert _points(got, 16) == want
    assert lb.limbs_to_int_batch(got.z) == [0 if w is None else 1
                                            for w in want]


def test_iso_map_zero_denominators_give_the_identity():
    """x' at the pole of the isogeny: the mask is False, the oracle says
    identity, and the rest of the lanes map as the oracle does."""
    rng = np.random.default_rng(12)
    xs = [X_ISO_POLE, 0, 1, P - 1] + [int(v) % P for v in rng.integers(
        1, 2 ** 62, 4)]
    ys = [5, 7, 11, 13] + [int(v) for v in rng.integers(1, 2 ** 62, 4)]
    x = bt.plane(xs, 8, device=CPU)
    y = bt.plane(ys, 8, device=CPU)
    xo, yo, ok = swu.iso_map(x, y)
    want = [oracle.iso(a, b) for a, b in zip(xs, ys)]
    assert ok.tolist() == [w is not None for w in want]
    assert not ok[0]
    for i, w in enumerate(want):
        if w is not None:
            assert (lb.limbs_to_int_batch(xo[:, i:i + 1])[0],
                    lb.limbs_to_int_batch(yo[:, i:i + 1])[0]) == w


# --- the JAX package's device cores (slow: they compile JAX pipelines) ---

@pytest.mark.slow
def test_cores_match_jax():
    """`_ro_bytes_core`, `_nu_bytes_core` and `swu.set_uniform_bytes`
    against the JAX package's on the edge strings and seeded ones."""
    import jax.numpy as jnp
    from secp256k1_tpu.ops import swu as jswu
    uniform = _edge_uniform()
    rows = np.stack([np.frombuffer(s, np.uint8) for s in uniform])
    other = rows[::-1].copy()
    port = [bt.byte_plane_np(r, 16, CPU) for r in (rows, other)]
    jax_in = [jnp.asarray(np.ascontiguousarray(r.T)) for r in (rows, other)]
    for got, want in ((h2c._ro_bytes_core(*port),
                       jh2c._ro_bytes_core(*jax_in)),
                      (h2c._nu_bytes_core(port[0]),
                       jh2c._nu_bytes_core(jax_in[0])),
                      (swu.set_uniform_bytes(port[0]),
                       jswu.set_uniform_bytes(jax_in[0]))):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64))
