"""The port's MSM against the JAX package on the same inputs.

Marked `slow`: it jits the JAX MSM pipelines (point adds inside scans and
maps) on XLA:CPU, which takes minutes, so tier-1 (`-m 'not slow'`) leaves
it out.  Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_msm_vs_jax.py -m slow

Both packages get the same numpy inputs through
`secp256k1_tpu_torch.convert`.  Where both take the same path (on the CPU
the JAX package always takes sort + scan, its Pallas kernels being off)
the projective X, Y, Z must be equal bit for bit; at 2,048 points the port
takes the bucket path and JAX sort + scan, so there the affine points must
be equal, as they must for the bucket kernel's signed digits against the
JAX sort + scan buckets of the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.ops import msm as jmsm
from secp256k1_tpu.ops import point as jpt
from secp256k1_tpu.ops import table as jtbl
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import msm
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = hc.P, hc.N

pytestmark = pytest.mark.slow


def _rand(rng, m, k):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


def _inputs(n, seed, z=True):
    """n scalars and n points (8 distinct, random Z) as numpy planes."""
    rng = np.random.default_rng(seed)
    base = [hc.mul(a + 1, hc.G) for a in _rand(rng, N - 1, 8)]
    pts = [base[i] for i in rng.integers(0, 8, n)]
    zs = [v + 1 for v in _rand(rng, P - 1, n)] if z else [1] * n
    xyz = [[p[0] * s % P for p, s in zip(pts, zs)],
           [p[1] * s % P for p, s in zip(pts, zs)], zs]
    planes = tuple(lb.int_to_limbs_batch(c).astype(np.uint32) for c in xyz)
    ks = lb.int_to_limbs_batch(_rand(rng, N, n)).astype(np.uint32)
    return ks, planes


def _t(arr):
    """numpy uint32 rows of any shape -> an int32 tensor."""
    return torch.as_tensor(np.asarray(arr).astype(np.int64)).to(torch.int32)


def _jax_point(planes):
    return jpt.Point(*[jnp.asarray(c) for c in planes])


def _same(port, jax_out):
    """Port planes [16, B] against JAX planes [16, *batch], bit for bit."""
    for g, w in zip(port, jax_out):
        w = np.asarray(w)
        assert np.array_equal(convert.plane_from_torch(g),
                              w.reshape(16, -1))


def _affine(planes):
    xs, ys, zs = (lb.limbs_to_int_batch(np.asarray(c).reshape(16, -1)
                                        .astype(np.int64)) for c in planes)
    return [None if z == 0 else (x * pow(z, P - 2, P) % P,
                                 y * pow(z, P - 2, P) % P)
            for x, y, z in zip(xs, ys, zs)]


@pytest.mark.parametrize("w", [4, 2])
def test_multi_scalar_mult_matches_jax(w):
    ks, planes = _inputs(32, w)
    want = jax.jit(jmsm.multi_scalar_mult, static_argnums=2)(
        jnp.asarray(ks), _jax_point(planes), w)
    got = msm.multi_scalar_mult(convert.plane_to_torch(ks),
                                convert.point_to_torch(planes), w)
    _same(got, want)


def test_straus_matches_jax():
    ks, planes = _inputs(8, 5)
    want = jax.jit(jmsm.multi_scalar_mult_straus)(jnp.asarray(ks),
                                                  _jax_point(planes))
    got = msm.multi_scalar_mult_straus(convert.plane_to_torch(ks),
                                       convert.point_to_torch(planes))
    _same(got, want)


def test_merge_sums_and_fold_match_jax():
    """_lane_merge over a JAX bucket slab, the weighted sums of a batch of
    windows (JAX: vmap) and the Horner fold."""
    _, planes = _inputs(3 * 256, 6)
    slab = np.stack(planes).reshape(3, 16, 3, 2, 128).transpose(2, 0, 1, 3, 4)
    want = jax.jit(jmsm._lane_merge)(jnp.asarray(slab))   # [3, 3, 16]
    got = msm._lane_merge(convert.buckets_to_torch(slab[None])[0])
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))

    _, planes = _inputs(2 * 16, 7)
    rows = np.stack(planes).reshape(3, 16, 2, 16).transpose(2, 3, 0, 1)
    want = jax.jit(jax.vmap(jmsm._weighted_bucket_sum))(jnp.asarray(rows))
    got = msm._weighted_bucket_sum(_t(rows))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))

    wsums = np.asarray(want)
    fold = jax.jit(jmsm.combine_windows, static_argnums=1)(
        jnp.asarray(wsums), 4)
    _same(msm.combine_windows(_t(wsums), 4), fold)


def _fold_rows(case):
    """[W, 3, 16] uint32 window-sum rows and the window bits: "w4" W = 4,
    w = 4 and "w8" W = 3, w = 8 (random Z); "edge" W = 6, w = 4, least
    significant first: B, B (equal consecutive sums), the identity
    (0, Z, 0), the identity (0, 1, 0), 16 A (equal to the accumulator at
    its add), A."""
    rng = np.random.default_rng({"w4": 21, "w8": 22, "edge": 23}[case])
    if case == "edge":
        a, b = (hc.mul(k + 1, hc.G) for k in _rand(rng, N - 1, 2))
        w, pts = 4, [b, b, None, None, hc.mul(16, a), a]
    else:
        w, n = (4, 4) if case == "w4" else (8, 3)
        pts = [hc.mul(k + 1, hc.G) for k in _rand(rng, N - 1, n)]
    zs = [v + 1 for v in _rand(rng, P - 1, len(pts))]
    xyz = [(0, 1 if i == 3 else z, 0) if q is None
           else (q[0] * z % P, q[1] * z % P, z)
           for i, (q, z) in enumerate(zip(pts, zs))]
    planes = [lb.int_to_limbs_batch([t[i] for t in xyz]).astype(np.uint32)
              for i in range(3)]
    return np.stack(planes).transpose(2, 0, 1).copy(), w


@pytest.mark.parametrize("case", ["w4", "w8", "edge"])
def test_fold_matches_jax_combine_windows(case):
    """The port's combine_windows (one msm_fold; its plain version on the
    CPU) against the JAX lax.scan fold, projective X, Y, Z bit for bit."""
    rows, w = _fold_rows(case)
    want = jax.jit(jmsm.combine_windows, static_argnums=1)(
        jnp.asarray(rows), w)
    _same(msm.combine_windows(_t(rows), w), want)


def test_lane_table_and_trivial_ladder_match_jax():
    ks, planes = _inputs(4, 8)
    want = jax.jit(jtbl.build_lane_table)(_jax_point(planes))
    got = tbl.build_lane_table(convert.point_to_torch(planes))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    want = jax.jit(jpt.scalar_mult_trivial)(jnp.asarray(ks),
                                            _jax_point(planes))
    _same(pt.scalar_mult_trivial(convert.plane_to_torch(ks),
                                 convert.point_to_torch(planes)), want)


def test_bucket_path_matches_jax_affine(monkeypatch):
    """2,048 points: the port takes the bucket path (lane slots shrunk to
    keep the plain lane merge to seconds), JAX on the CPU sort + scan."""
    monkeypatch.setattr(msm, "MSM_SLOTS", 128)
    ks, planes = _inputs(2048, 9, z=False)
    points = convert.point_to_torch(planes)
    assert msm._fused_msm_ok(points, 4)
    want = jax.jit(jmsm.multi_scalar_mult)(jnp.asarray(ks),
                                           _jax_point(planes))
    got = msm.multi_scalar_mult(convert.plane_to_torch(ks), points)
    assert _affine(got) == _affine(want) and _affine(got)[0] is not None


def test_bucket_kernel_skips_magnitude_zero_with_the_sign_bit():
    """Signed digits (magnitude | sign << 6) with magnitude 0 and the sign
    bit set pinned on lanes of window 0 and of window 1: the bucket
    kernel's entry point (its plain version on the CPU) adds them to no
    bucket.  Each bucket, its lane slots summed, equals in affine the JAX
    `_bucket_accumulate` bucket of the same points, y negated where the
    sign bit is set, and the python-int sum."""
    n, nb, m_slots = 32, 8, 8
    rng = np.random.default_rng(66)
    _, planes = _inputs(n, 66)
    digits = rng.integers(0, nb + 1, (2, n)) | (rng.integers(0, 2, (2, n))
                                                << 6)
    digits[0, :4] = 1 << 6
    digits[0, 4:6] = [0, nb | 1 << 6]
    digits[1, 8:12] = 1 << 6
    digits[1, 12:14] = [0, 1]
    got = K.msm_bucket_accumulate_all(
        torch.as_tensor(digits, dtype=torch.int32),
        *convert.point_to_torch(planes), nb, signed_digits=True,
        m_slots=m_slots)
    assert got.shape == (2, nb, 3, 16, m_slots)
    accumulate = jax.jit(jmsm._bucket_accumulate, static_argnums=2)
    points = _affine(planes)
    for w in range(2):
        mag, neg = digits[w] & 0x3F, (digits[w] >> 6) == 1
        ys = lb.limbs_to_int_batch(planes[1].astype(np.int64))
        zs = lb.limbs_to_int_batch(planes[2].astype(np.int64))
        y_neg = [(P - y) % P if s else y for y, s in zip(ys, neg)]
        jplanes = np.stack([planes[0], lb.int_to_limbs_batch(y_neg)
                            .astype(np.uint32), planes[2]])
        buckets = np.asarray(accumulate(jnp.asarray(jplanes),
                                        jnp.asarray(mag.astype(np.uint32)),
                                        nb + 1))         # [nb + 1, 3, 16]
        want_jax = _affine([buckets[1:, c].T for c in range(3)])
        for b in range(nb):
            slots = _affine([got[w, b, c] for c in range(3)])
            port = None
            for q in slots:
                port = hc.add(port, q)
            want = None
            for i in range(n):
                if mag[i] == b + 1:
                    q = points[i]
                    want = hc.add(want, hc.neg(q) if neg[i] else q)
            assert port == want_jax[b] == want, (w, b)
        assert all(zs)
