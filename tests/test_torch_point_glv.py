"""The port's point formulas and GLV scalar multiplication against the JAX
package and python ints.

Seeded inputs go through `secp256k1_tpu_torch.convert` to both packages and
every comparison is exact (tolerance 0).  The point formulas must give the
same projective X, Y, Z as JAX `ops/point.py` and as the Pallas bodies
(`_point_add_body`, `_point_add_mixed_body`, `_point_double_body`, run
eagerly under `jax.disable_jit()` and canonicalized with `fcanon`), because
the CUDA kernels and the plain versions follow the same step order.  The GLV
loop is held against python ints: on the CPU the JAX package takes its
unsigned 32-window path, whose projective result differs from the signed
kernel's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.ops import glv as jglv
from secp256k1_tpu.ops import point as jpt
from secp256k1_tpu.ops.pallas import kernels as pk
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import glv
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = hc.P, hc.N
LANES = 128
RNG = np.random.default_rng(20260)


def _rand(m, k, rng=RNG):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


_BASE_K = _rand(N, 6)
_BASE_POINTS = [hc.mul(k, hc.G) for k in _BASE_K]


def _proj(affine, z_vals):
    """Affine points (None = identity) -> projective int triples scaled by
    z (the identity becomes (0, z, 0))."""
    out = []
    for a, z in zip(affine, z_vals):
        if a is None:
            out.append((0, z, 0))
        else:
            out.append((a[0] * z % P, a[1] * z % P, z))
    return out


def _zs(k, rng):
    return [v + 1 for v in _rand(P - 1, k, rng)]


def _point_np(triples):
    return tuple(lb.int_to_limbs_batch([t[i] for t in triples])
                 .astype(np.uint32) for i in range(3))


def _operands(seed):
    """128 lanes of (P, Q) projective pairs: random, P == Q, P == -Q and
    identities on either side, each with random Z."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(_BASE_POINTS), size=(2, LANES))
    a = [_BASE_POINTS[i] for i in pick[0]]
    b = [_BASE_POINTS[i] for i in pick[1]]
    for i in range(0, 8):
        b[i] = a[i]                            # doubling through add
    for i in range(8, 16):
        b[i] = hc.neg(a[i])                    # P + (-P) = identity
    for i in range(16, 20):
        a[i] = None
    for i in range(20, 24):
        b[i] = None
    p = _proj(a, _zs(LANES, rng))
    q = _proj(b, _zs(LANES, rng))
    return _point_np(p), _point_np(q), a, b


def _jax_point(arrs):
    return jpt.Point(*[jnp.asarray(a) for a in arrs])


def _torch_point(arrs):
    return pt.Point(*[convert.plane_to_torch(a) for a in arrs])


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(convert.plane_from_torch(g),
                              np.asarray(w).reshape(16, -1))


def _affine(point):
    xs, ys, zs = (lb.limbs_to_int_batch(c) for c in point)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, P - 2, P)
            out.append((x * zi % P, y * zi % P))
    return out


FORMULAS = ["add", "add_mixed", "double"]


def _mixed_operands(seed):
    p_np, _, _, _ = _operands(seed)
    rng = np.random.default_rng(seed + 1)
    pick = rng.integers(0, len(_BASE_POINTS), size=LANES)
    q = _proj([_BASE_POINTS[i] for i in pick], [1] * LANES)
    return p_np, _point_np(q)


def _formulas(mod, point_cls, p, q, pm, qx, qy):
    """{formula: (x, y, z)} for one package: add and double on (p, q), the
    mixed add on pm and the affine (qx, qy)."""
    p, q, pm = point_cls(*p), point_cls(*q), point_cls(*pm)
    return {"add": tuple(mod.add(p, q)), "double": tuple(mod.double(p)),
            "add_mixed": tuple(mod.add_mixed(pm, qx, qy))}


@functools.cache
def _formula_operands():
    p_np, q_np, _, _ = _operands(1)
    pm_np, qm_np = _mixed_operands(3)
    return p_np, q_np, pm_np, qm_np[0], qm_np[1]


@functools.cache
def _jax_formulas():
    """The three JAX ops/point.py formulas in a single jit."""
    args = jax.tree_util.tree_map(jnp.asarray, _formula_operands())
    out = jax.jit(lambda *a: _formulas(jpt, jpt.Point, *a))(*args)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", FORMULAS)
def test_point_formula_matches_jax(name):
    args = jax.tree_util.tree_map(convert.plane_to_torch,
                                  _formula_operands())
    got = _formulas(pt, pt.Point, *args)[name]
    _assert_same(got, _jax_formulas()[name])


@pytest.mark.parametrize("name", FORMULAS)
def test_point_formula_matches_pallas_body(name):
    """The same projective X, Y, Z as the Pallas bodies, run eagerly."""
    if name == "add_mixed":
        p_np, q_np = _mixed_operands(4)
    else:
        p_np, q_np, _, _ = _operands(2)

    def rows(a):
        return [jnp.asarray(a[i].reshape(1, LANES)) for i in range(16)]

    with jax.disable_jit():
        if name == "add":
            out = pk._point_add_body(*[rows(a) for a in p_np + q_np])
            got = pt.add(_torch_point(p_np), _torch_point(q_np))
        elif name == "double":
            out = pk._point_double_body(*[rows(a) for a in p_np])
            got = pt.double(_torch_point(p_np))
        else:
            out = pk._point_add_mixed_body(*[rows(a) for a in p_np],
                                           rows(q_np[0]), rows(q_np[1]))
            got = pt.add_mixed(_torch_point(p_np),
                               convert.plane_to_torch(q_np[0]),
                               convert.plane_to_torch(q_np[1]))
        want = [np.stack([np.asarray(r).reshape(LANES) for r in pk.fcanon(c)])
                for c in out]
    _assert_same(got, want)


def test_point_add_against_python_ints():
    p_np, q_np, a, b = _operands(5)
    got = _affine(pt.add(_torch_point(p_np), _torch_point(q_np)))
    assert got == [hc.add(x, y) for x, y in zip(a, b)]
    dbl = _affine(pt.double(_torch_point(p_np)))
    assert dbl == [hc.add(x, x) for x in a]


def test_point_predicates_and_selects():
    p_np, q_np, a, b = _operands(6)
    tp, tq = _torch_point(p_np), _torch_point(q_np)
    assert pt.is_identity(tp).tolist() == [x is None for x in a]
    assert bool(pt.on_curve(tp).all()) and bool(pt.on_curve(tq).all())
    off = pt.Point(tp.x, fe.add(tp.y, fe.one((LANES,), "cpu")), tp.z)
    assert pt.on_curve(off).tolist() == [x is None for x in a]
    mask = torch.as_tensor(RNG.integers(0, 2, size=LANES).astype(bool))
    sel = _affine(pt.select(mask, tp, tq))
    assert sel == [x if m else y for m, x, y in zip(mask.tolist(), a, b)]
    neg = _affine(pt.cneg(mask, tp))
    assert neg == [hc.neg(x) if m else x for m, x in zip(mask.tolist(), a)]
    assert _affine(pt.identity((3,), "cpu")) == [None] * 3
    assert _affine(pt.generator((2,), "cpu")) == [hc.G] * 2


# ---------------------------------------------------------------------------
# GLV.
# ---------------------------------------------------------------------------

GLV_KS = [0, 1, N - 1, glv.LAMBDA, N - glv.LAMBDA, 2**128, 2**128 - 1] \
    + _rand(N, 25)


def test_glv_split_matches_jax():
    k_np = lb.int_to_limbs_batch(GLV_KS).astype(np.uint32)
    jk1, jk2 = jax.jit(jglv.split)(jnp.asarray(k_np))
    k1, k2 = glv.split(convert.plane_to_torch(k_np))
    _assert_same((k1, k2), (jk1, jk2))
    lam = glv.LAMBDA
    for k, a, b in zip(GLV_KS, lb.limbs_to_int_batch(k1),
                       lb.limbs_to_int_batch(k2)):
        assert (a + b * lam - k) % N == 0
        assert min(a, N - a) < 2**129 and min(b, N - b) < 2**129


def test_signed_digits_128_matches_jax():
    short = [k % 2**128 for k in GLV_KS] + [2**128 - 1, 0x88888888 * 2**96]
    k_np = lb.int_to_limbs_batch(short).astype(np.uint32)
    want = jax.jit(jglv._signed_digits_128)(jnp.asarray(k_np))
    got = glv._signed_digits_128(convert.plane_to_torch(k_np))
    assert got.shape == (33, len(short)) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for k, col in zip(short, got.t().tolist()):          # most significant
        val = 0                                          # window first
        for d in col:
            val = val * 16 + (-(d & 0xF) if d >> 4 else d & 0xF)
        assert val == k


def _glv_lanes(ks, seed):
    """Projective points with random Z for each k, and k*P as ints."""
    rng = np.random.default_rng(seed)
    affine = [_BASE_POINTS[i] for i in
              rng.integers(0, len(_BASE_POINTS), size=len(ks))]
    p = _torch_point(_point_np(_proj(affine, _zs(len(ks), rng))))
    return p, [hc.mul(k % N, a) for k, a in zip(ks, affine)]


def test_glv_plain_kernel_with_signed_zero_digits():
    """A magnitude-0 digit with the sign bit set is a zero digit: the whole
    identity in window 0, the accumulator passed through later."""
    ks = GLV_KS[:16]
    p, want = _glv_lanes(ks, 7)
    d1, d2, p1, p2 = glv.glv_kernel_operands(
        convert.plane_to_torch(lb.int_to_limbs_batch(ks)), p)
    assert bool(((d1[0] & 0xF) == 0).any())
    d1 = torch.where((d1 & 0xF) == 0, d1 | 16, d1)
    d2 = torch.where((d2 & 0xF) == 0, d2 | 16, d2)
    assert int(((d1 == 16) | (d2 == 16)).sum()) > 16
    K.reset_counts()
    got = K.glv_windowed_mult_signed_from_points(d1, d2, p1, p2)
    assert K.PLAIN_CALLS["glv_windowed_mult_signed_from_points"] == 1
    assert K.LAUNCHES["glv_windowed_mult_signed_from_points"] == 0
    assert all(g.dtype == torch.int32 for g in got)
    assert _affine(got) == want


def _digit_value(col):
    """A lane's signed 4-bit digits, most significant window first."""
    val = 0
    for d in map(int, col):
        val = val * 16 + (-(d & 0xF) if d >> 4 else d & 0xF)
    return val


@pytest.mark.parametrize("case", ["identity-p1", "identity-p2",
                                  "magnitude-8"])
def test_glv_plain_kernel_edge_operands(case):
    """The plain #4 on the edges the CUDA kernel must match: P1 or P2 the
    identity (0, 1, 0) or (0, Z, 0) (its table is all identities), every
    digit +8 or -8 (the table's last entry, y negated or not), magnitude 0
    with the sign bit set in window 0.  k1*P1 + k2*P2 against python ints
    from the digits themselves."""
    rng = np.random.default_rng({"identity-p1": 1, "identity-p2": 2,
                                 "magnitude-8": 3}[case])
    lanes = 8
    mag = rng.integers(0, 9, (33, lanes))
    d1 = mag | (rng.integers(0, 2, (33, lanes)) << 4)
    d2 = rng.integers(0, 9, (33, lanes)) | (rng.integers(0, 2, (33, lanes))
                                            << 4)
    d1[0, :2] = 16                          # magnitude 0, sign bit set
    if case == "magnitude-8":
        d1[:, 2:5] = 8
        d2[:, 3:6] = 8 | 16
    a1 = [_BASE_POINTS[i] for i in rng.integers(0, 6, lanes)]
    a2 = [_BASE_POINTS[i] for i in rng.integers(0, 6, lanes)]
    z1, z2 = _zs(lanes, rng), _zs(lanes, rng)
    if case == "identity-p1":
        a1[:4] = [None] * 4
        z1[:2] = [1, 1]
    if case == "identity-p2":
        a2[:4] = [None] * 4
    p1 = _torch_point(_point_np(_proj(a1, z1)))
    p2 = _torch_point(_point_np(_proj(a2, z2)))
    t1, t2 = (torch.as_tensor(d, dtype=torch.int32) for d in (d1, d2))
    K.reset_counts()
    got = K.glv_windowed_mult_signed_from_points(t1, t2, tuple(p1),
                                                 tuple(p2))
    assert K.PLAIN_CALLS["glv_windowed_mult_signed_from_points"] == 1
    want = []
    for i in range(lanes):
        k1, k2 = _digit_value(d1[:, i]), _digit_value(d2[:, i])
        q1 = hc.mul(k1 % N, a1[i]) if a1[i] is not None else None
        q2 = hc.mul(k2 % N, a2[i]) if a2[i] is not None else None
        want.append(hc.add(q1, q2))
    assert _affine(got) == want


def test_glv_scalar_mult_against_python_ints():
    ks = GLV_KS[:16]
    p, want = _glv_lanes(ks, 8)
    got = glv.scalar_mult(convert.plane_to_torch(lb.int_to_limbs_batch(ks)),
                          p)
    assert _affine(got) == want


def test_mul_beta_is_lambda_multiple():
    p, _ = _glv_lanes([1] * 8, 9)
    got = _affine(glv.mul_beta(p))
    assert got == [hc.mul(glv.LAMBDA, a) for a in _affine(p)]
