"""The port's alternative engines and ECDH against the JAX package.

Marked `slow`: it jits JAX pipelines (the GLV scan, the fixed-base scans,
batched ECDH) on XLA:CPU and runs the GLV Pallas bodies eagerly, which
takes minutes, so tier-1 (`-m 'not slow'`) leaves it out.  Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_engines_vs_jax.py -m slow

Both packages get the same numpy inputs through
`secp256k1_tpu_torch.convert`; every comparison is exact.

- On the CPU the JAX `glv.scalar_mult` runs with its Pallas kernels off,
  which is the not-mega schedule (identity start, `double_n`, lookup,
  add, select): its projective X, Y, Z against the port's
  `set_mega(False)` route.
- The Pallas bodies `_glv_mega_frompoints_kernel` (signed_digits=True,
  n_entries=8, and False, 15) and `_glv_mega_kernel`, run eagerly on
  numpy refs at three windows, against the plain #4, #7 and #9; `_point_add_mixed_body`
  and four `_point_double_body` against the plain #13 and #12.
- The JAX `table.scalar_base_mult` (on the CPU always its scan path) at
  `set_base_signed(False)` and at signed widths 4, 6 and 12: the port's
  scan path in X, Y, Z, and the port's routed result (a fused kernel at
  widths 6 and 12 and unsigned 8) in affine.
- The JAX `ecdh_batch_arrays` on 16 lanes with bad lanes, byte for byte
  and status for status against the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.models import ecdh as jecdh
from secp256k1_tpu.ops import glv as jglv
from secp256k1_tpu.ops import table as jtbl
from secp256k1_tpu.ops.pallas import kernels as pk
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.models import ecdh
from secp256k1_tpu_torch.ops import glv
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = hc.P, hc.N
LANES = 16
EAGER_LANES = 4
EAGER_WINDOWS = 3

pytestmark = pytest.mark.slow


def _rand(rng, m, k):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


def _points_np(rng, n, z=True):
    """n random points with random Z (or Z = 1) as numpy uint32 planes,
    and their affine ints."""
    pts = [hc.mul(a + 1, hc.G) for a in _rand(rng, N - 1, n)]
    zs = [v + 1 for v in _rand(rng, P - 1, n)] if z else [1] * n
    xyz = [[p[0] * s % P for p, s in zip(pts, zs)],
           [p[1] * s % P for p, s in zip(pts, zs)], zs]
    return tuple(lb.int_to_limbs_batch(c).astype(np.uint32)
                 for c in xyz), pts


def _np(planes):
    return [np.asarray(c).astype(np.uint32).reshape(c.shape[0], -1)
            for c in planes]


def _assert_same(got, want):
    """Port planes (tensors) against JAX planes, bit for bit."""
    for g, w in zip(got, want):
        assert np.array_equal(convert.plane_from_torch(g), _np([w])[0])


def _affine(planes):
    xs, ys, zs = (lb.limbs_to_int_batch(np.asarray(c).astype(np.int64)
                                        .reshape(16, -1)) for c in planes)
    return [None if z == 0 else
            (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)
            for x, y, z in zip(xs, ys, zs)]


def test_not_mega_route_matches_jax_glv_projectively():
    rng = np.random.default_rng(31)
    p_np, _ = _points_np(rng, LANES)
    k_np = lb.int_to_limbs_batch(_rand(rng, N, LANES)).astype(np.uint32)
    want = jax.jit(lambda k, x, y, z: tuple(jglv.scalar_mult(
        k, jglv.pt.Point(x, y, z))))(jnp.asarray(k_np),
                                     *map(jnp.asarray, p_np))
    try:
        K.set_mega(False)
        K.reset_counts()
        got = glv.scalar_mult(convert.plane_to_torch(k_np),
                              convert.point_to_torch(p_np))
        assert K.PLAIN_CALLS["point_lookup_add"] == 64
    finally:
        K.set_mega(True)
    _assert_same(got, want)


def _eager_rows(a):
    """numpy [L, lanes] -> a numpy ref [L, 1, lanes]."""
    return np.ascontiguousarray(a.reshape(a.shape[0], 1, -1))


def _glv_operands(seed):
    rng = np.random.default_rng(seed)
    p1, _ = _points_np(rng, EAGER_LANES)
    p2, _ = _points_np(rng, EAGER_LANES)
    d1 = rng.integers(0, 16, (EAGER_WINDOWS, EAGER_LANES)).astype(np.uint32)
    d2 = rng.integers(0, 16, (EAGER_WINDOWS, EAGER_LANES)).astype(np.uint32)
    d1[0, 0] = 0                      # digit 0 in window 0
    d1[:, 1] = 0                      # an all-zero digit column
    d1[:, 2] = d2[:, 2] = 15          # all-15 columns
    return p1, p2, d1, d2


def test_glv_from_points_unsigned_matches_the_pallas_body():
    p1, p2, d1, d2 = _glv_operands(41)
    outs = [np.zeros((16, 1, EAGER_LANES), np.uint32) for _ in range(3)]
    scratch = [np.zeros((15, 3, 16, 1, EAGER_LANES), np.uint32)
               for _ in range(2)]
    kernel = pk._glv_mega_frompoints_kernel(EAGER_WINDOWS, 15, False, False)
    with jax.disable_jit():
        kernel(_eager_rows(d1), _eager_rows(d2),
               *[_eager_rows(c) for c in p1 + p2], *outs, *scratch)
    got = K.glv_windowed_mult_from_points_plain(
        convert.plane_to_torch(d1), convert.plane_to_torch(d2),
        tuple(convert.plane_to_torch(c) for c in p1),
        tuple(convert.plane_to_torch(c) for c in p2))
    _assert_same(got, outs)


def test_glv_signed_from_points_matches_the_pallas_body():
    """The plain #4 against `_glv_mega_frompoints_kernel(signed_digits=
    True, n_entries=8)` run eagerly: magnitude 0 with the sign bit set
    (window 0 and later), magnitude 8 of either sign, P1 the identity on
    lane 3."""
    rng = np.random.default_rng(47)
    p1, _ = _points_np(rng, EAGER_LANES)
    p2, _ = _points_np(rng, EAGER_LANES)
    p1 = [c.copy() for c in p1]
    p1[1][:, 3] = p1[2][:, 3]                    # (0, Z, 0)
    p1[0][:, 3] = 0
    p1[2][:, 3] = 0
    shape = (EAGER_WINDOWS, EAGER_LANES)
    d1 = (rng.integers(0, 9, shape) | rng.integers(0, 2, shape) << 4)
    d2 = (rng.integers(0, 9, shape) | rng.integers(0, 2, shape) << 4)
    d1[:, 0] = 16                                # magnitude 0, sign set
    d2[0, 1] = 16
    d1[:, 2], d2[:, 2] = 8, 8 | 16               # magnitude 8
    d1, d2 = d1.astype(np.uint32), d2.astype(np.uint32)
    outs = [np.zeros((16, 1, EAGER_LANES), np.uint32) for _ in range(3)]
    scratch = [np.zeros((8, 3, 16, 1, EAGER_LANES), np.uint32)
               for _ in range(2)]
    kernel = pk._glv_mega_frompoints_kernel(EAGER_WINDOWS, 8, False, True)
    with jax.disable_jit():
        kernel(_eager_rows(d1), _eager_rows(d2),
               *[_eager_rows(c) for c in list(p1) + list(p2)], *outs,
               *scratch)
    got = K.glv_windowed_mult_signed_from_points_plain(
        convert.plane_to_torch(d1), convert.plane_to_torch(d2),
        tuple(convert.plane_to_torch(c) for c in p1),
        tuple(convert.plane_to_torch(c) for c in p2))
    _assert_same(got, outs)


def test_glv_tables_matches_the_pallas_body():
    p1, p2, d1, d2 = _glv_operands(43)
    t1 = tbl.build_lane_table(convert.point_to_torch(p1))
    t2 = tbl.build_lane_table(convert.point_to_torch(p2))
    tiles = [convert.lane_table_from_torch(t) for t in (t1, t2)]
    assert tiles[0].shape == (15, 3, 16, EAGER_LANES)
    assert torch.equal(convert.lane_table_to_torch(tiles[0]), t1)
    outs = [np.zeros((16, 1, EAGER_LANES), np.uint32) for _ in range(3)]
    kernel = pk._glv_mega_kernel(EAGER_WINDOWS, 15, False)
    with jax.disable_jit():
        kernel(_eager_rows(d1), _eager_rows(d2),
               *[np.ascontiguousarray(t.reshape(15, 3, 16, 1, -1))
                 for t in tiles], *outs)
    got = K.glv_windowed_mult_plain(convert.plane_to_torch(d1),
                                    convert.plane_to_torch(d2), t1, t2)
    _assert_same(got, outs)


def test_mixed_add_and_double4_match_the_pallas_bodies():
    rng = np.random.default_rng(47)
    p_np, _ = _points_np(rng, EAGER_LANES)
    q_np, _ = _points_np(rng, EAGER_LANES, z=False)

    def rows(a):
        return [jnp.asarray(a[i].reshape(1, EAGER_LANES)) for i in range(16)]

    def canon(out):
        return [np.stack([np.asarray(r).reshape(EAGER_LANES)
                          for r in pk.fcanon(c)]) for c in out]

    with jax.disable_jit():
        mixed = canon(pk._point_add_mixed_body(*[rows(a) for a in p_np],
                                               rows(q_np[0]), rows(q_np[1])))
        r = tuple(rows(a) for a in p_np)
        for _ in range(4):
            r = pk._point_double_body(*r)
        dbl4 = canon(r)
    p = convert.point_to_torch(p_np)
    _assert_same(K.point_add_mixed_plain(
        *p, convert.plane_to_torch(q_np[0]),
        convert.plane_to_torch(q_np[1])), mixed)
    _assert_same(K.point_double4_plain(*p), dbl4)


@pytest.mark.parametrize("signed,window", [(False, 8), (True, 4), (True, 6),
                                           (True, 12)])
def test_fixed_base_matches_jax_scalar_base_mult(signed, window):
    rng = np.random.default_rng(53 + window)
    ks = [1, N - 1, int("80" * 32, 16) % N] + _rand(rng, N, LANES - 3)
    k_np = lb.int_to_limbs_batch(ks).astype(np.uint32)
    jsigned, jwindow = jtbl.base_signed_enabled(), jtbl.base_window()
    try:
        jtbl.set_base_signed(signed)
        jtbl.set_base_window(window)
        want = jax.jit(lambda k: tuple(jtbl.scalar_base_mult(k)))(
            jnp.asarray(k_np))
    finally:
        jtbl.set_base_signed(jsigned)
        jtbl.set_base_window(jwindow)
    k = convert.plane_to_torch(k_np)
    # The port's scan path: the JAX scan's X, Y, Z.
    if signed:
        digits = tbl._signed_digits(k, window)
    else:
        digits = tbl._raw_digits(k, 8, 32).to(lb.DTYPE)
    table = tbl.base_table("cpu", window, signed)
    assert np.array_equal(convert.table_from_torch(table),
                          (jtbl.gen_base_tables_signed_np(window) if signed
                           else jtbl.gen_base_tables_np(8)))
    _assert_same(tbl._scan_base_mult(table, digits, signed), want)
    # The port's routed result (a fused kernel where the rule allows).
    try:
        tbl.set_base_signed(signed)
        tbl.set_base_window(window)
        got = tbl.scalar_base_mult(k)
    finally:
        tbl.set_base_signed(True)
        tbl.set_base_window(8)
    assert _affine(got) == _affine(want) == [hc.mul(v, hc.G) for v in ks]


def test_ecdh_batch_arrays_matches_jax_byte_for_byte():
    rng = np.random.default_rng(59)
    ks = _rand(rng, N - 1, LANES)
    ks = [k + 1 for k in ks]
    peers = [hc.mul(a + 1, hc.G) for a in _rand(rng, N - 1, LANES)]
    priv = np.frombuffer(b"".join(k.to_bytes(32, "big") for k in ks),
                         np.uint8).reshape(LANES, 32).copy()
    pubs = np.frombuffer(b"".join(hc.encode_point(p, compressed=True)
                                  for p in peers),
                         np.uint8).reshape(LANES, 33).copy()
    x_bad = 5
    while pow((x_bad ** 3 + 7) % P, (P - 1) // 2, P) != P - 1:
        x_bad += 1
    pubs[1, 0] = 0x05                                  # bad prefix
    pubs[2, 1:] = np.frombuffer(x_bad.to_bytes(32, "big"), np.uint8)
    priv[3] = 0                                        # k = 0
    priv[4] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)   # k = n
    want_shared, want_status = jecdh.ecdh_batch_arrays(priv, pubs)
    shared, status = ecdh.ecdh_batch_arrays(priv, pubs, device="cpu")
    assert status.tolist() == np.asarray(want_status).tolist()
    assert np.array_equal(shared, np.asarray(want_shared))
    assert status[1] == status[2] == ec.ERR_INVALID_PUBLIC_KEY
    assert status[3] == status[4] == ec.ERR_INVALID_SCALAR
    assert (status[5:] == ec.OK).all()
