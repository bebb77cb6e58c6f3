"""The port's Pippenger and Straus MSM on the CPU: the plain bucket kernel
against the Pallas kernel's body, the digit functions against the JAX
package, and every MSM result against python ints (`tests/gold.py`).

Tolerance 0 throughout.  The bucket oracle walks the points as the Pallas
`_msm_bucket_all_kernel` does (a masked select of the bucket, one complete
add, a masked write-back) with the Pallas `_point_add_body` run eagerly
under `jax.disable_jit()` and canonicalized with `fcanon`, one add a step
over all W * M lanes; it must give the same projective X, Y, Z as the plain
`msm_bucket_accumulate_all`.  Runs that take the bucket path shrink the lane
slots (`msm.MSM_SLOTS`) to keep the plain version's lane merge to seconds;
the path and its arithmetic are the same.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gold
from secp256k1_tpu.ops import msm as jmsm
from secp256k1_tpu.ops.pallas import kernels as pk
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import msm
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = gold.P, gold.N
RNG = np.random.default_rng(31337)


@pytest.fixture(autouse=True)
def _no_autograd():
    """The port never differentiates: without autograd's bookkeeping the
    plain versions' many small tensor ops run about twice as fast."""
    with torch.inference_mode():
        yield


def _rand(m, k, rng=RNG):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=torch.int32)


def _points(affine, z_vals=None):
    """Affine int points -> a port Point with Z = z (default 1)."""
    if z_vals is None:
        return pt.Point(_plane([a[0] for a in affine]),
                        _plane([a[1] for a in affine]),
                        fe.one((len(affine),), "cpu"))
    return pt.Point(_plane([a[0] * z % P for a, z in zip(affine, z_vals)]),
                    _plane([a[1] * z % P for a, z in zip(affine, z_vals)]),
                    _plane(z_vals))


def _affine(p):
    """Projective planes -> affine int points (None for the identity)."""
    xs, ys, zs = (lb.limbs_to_int_batch(c) for c in p)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, P - 2, P)
            out.append((x * zi % P, y * zi % P))
    return out


@functools.cache
def _base_logs(k=8):
    return [a + 1 for a in _rand(N - 1, k, np.random.default_rng(8))]


@functools.cache
def _base_points():
    return [gold.affine_mul(a, gold.GEN) for a in _base_logs()]


def _case(n, seed):
    """n scalars and n points a_i * G of known a_i, and the expected
    sum: (sum_i k_i a_i mod n) * G by one gold multiplication."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(_base_logs()), n)
    ks = _rand(N, n, rng)
    return ks, [_base_points()[i] for i in pick], pick


def _want(ks, pick):
    total = sum(k * _base_logs()[i] for k, i in zip(ks, pick)) % N
    return gold.affine_mul(total, gold.GEN) if total else None


# ---------------------------------------------------------------------------
# The bucket kernel's plain version against the Pallas body.
# ---------------------------------------------------------------------------

def _eager_add(a, b):
    """[3, 16, L] + [3, 16, L] by the Pallas `_point_add_body`, eagerly."""
    lanes = a.shape[-1]

    def rows(v):
        return [jnp.asarray(v[i].reshape(1, lanes)) for i in range(16)]

    with jax.disable_jit():
        out = pk._point_add_body(*[rows(a[c]) for c in range(3)],
                                 *[rows(b[c]) for c in range(3)])
        return np.stack([np.stack([np.asarray(r).reshape(lanes)
                                   for r in pk.fcanon(c)]) for c in out])


def _neg_y(y):
    vals = [(P - v) % P for v in lb.limbs_to_int_batch(y.astype(np.int64))]
    return lb.int_to_limbs_batch(vals).astype(np.uint32)


# Two steps of M points (each step is one eager add of about 4 s, all
# cases in one); lane slots 0-43 take the same digit in both, so the second
# step adds into buckets the first filled.  n = 511 and 513: magnitudes
# above nb on a fifth of the digits, which must be discarded (the CUDA
# kernel addresses the bucket by the digit and skips them).
BUCKET_CASES = [(False, 512), (True, 512), (False, 300), (True, 300),
                (False, 511), (True, 513)]
BUCKET_W, BUCKET_M = 3, 256


def _bucket_inputs(signed, n):
    rng = np.random.default_rng(7 + n + signed)
    nb = 8 if signed else 15
    digits = rng.integers(0, nb + 1, (BUCKET_W, n))
    if n in (511, 513):
        over = rng.random((BUCKET_W, n)) < 0.2
        digits[over] = rng.integers(nb + 1, 64, int(over.sum()))
        if not signed:
            digits[1, 5:9] = [64, 65, 1 << 20, 2**31 - 1]
    if signed:
        digits |= rng.integers(0, 2, (BUCKET_W, n)) << 6
    digits[0, :5] = [0, 1, nb, 0, nb]                    # edges on lane slots
    digits[:, BUCKET_M:BUCKET_M + 44] = digits[:, :44]   # refill buckets
    affine = [_base_points()[i] for i in rng.integers(0, 8, n)]
    affine[3] = affine[2]                                # repeated points
    p = _points(affine, [v + 1 for v in _rand(P - 1, n, rng)])
    return digits, p, nb


@functools.cache
def _oracle_buckets():
    """{case: [W, nb, 3, 16, M] partial buckets} by the TPU kernel's walk
    (slot j = n mod M, steps of M points).  The four cases walk together:
    each step is one eager `_point_add_body` over all their W * M lanes."""
    w, m = BUCKET_W, BUCKET_M
    accs, inputs = {}, {}
    for case in BUCKET_CASES:
        digits, p, nb = _bucket_inputs(*case)
        inputs[case] = (digits, convert.point_from_torch(p), nb)
        accs[case] = np.zeros((w, nb, 3, 16, m), np.uint32)
        accs[case][:, :, 1, 0] = 1                       # identity (0, 1, 0)
    for lo in range(0, max(n for _, n in BUCKET_CASES), m):
        sels, pts, hits = [], [], []
        for (signed, n), (digits, xyz, nb) in inputs.items():
            k = max(0, min(m, n - lo))
            d = np.zeros((w, m), np.int64)
            d[:, :k] = digits[:, lo:lo + k]
            p = np.zeros((3, 16, w, m), np.uint32)
            for c in range(3):
                p[c, :, :, :k] = xyz[c][:, None, lo:lo + k]
            p = p.reshape(3, 16, w * m)
            if signed:
                neg = ((d >> 6) == 1).reshape(-1)
                d = d & 0x3F
                p[1] = np.where(neg, _neg_y(p[1]), p[1])
            acc = accs[(signed, n)]
            sel = acc[:, 0]
            for b in range(1, nb):
                sel = np.where((d == b + 1)[:, None, None], acc[:, b], sel)
            sels.append(sel.transpose(1, 2, 0, 3).reshape(3, 16, w * m))
            pts.append(p)
            hits.append(d)
        added = _eager_add(np.concatenate(sels, -1), np.concatenate(pts, -1))
        for i, case in enumerate(inputs):
            part = added[..., i * w * m:(i + 1) * w * m]
            part = part.reshape(3, 16, w, m).transpose(2, 0, 1, 3)
            acc, d = accs[case], hits[i]
            for b in range(acc.shape[1]):
                acc[:, b] = np.where((d == b + 1)[:, None, None], part,
                                     acc[:, b])
    return accs


@pytest.mark.parametrize("signed,n", BUCKET_CASES,
                         ids=["unsigned", "signed", "unsigned-ragged",
                              "signed-ragged", "unsigned-above-nb",
                              "signed-above-nb"])
def test_plain_bucket_kernel_matches_pallas_body(signed, n):
    digits, p, nb = _bucket_inputs(signed, n)
    K.reset_counts()
    got = K.msm_bucket_accumulate_all(
        torch.as_tensor(digits, dtype=torch.int32), *p, nb,
        signed_digits=signed, m_slots=BUCKET_M)
    assert K.PLAIN_CALLS["msm_bucket_accumulate_all"] == 1
    assert K.LAUNCHES["msm_bucket_accumulate_all"] == 0
    assert got.shape == (BUCKET_W, nb, 3, 16, BUCKET_M)
    assert got.dtype == torch.int32
    want = _oracle_buckets()[(signed, n)]
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # The converter takes the JAX slab layout to this one and back.
    tiled = convert.buckets_from_torch(got)
    assert tiled.shape == (BUCKET_W, nb, 3, 16, BUCKET_M // 128, 128)
    assert torch.equal(convert.buckets_to_torch(tiled), got)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_plain_bucket_walk_with_three_slots_matches_python_ints(signed):
    """m_slots = 3 (a shape the Pallas body does not take) at a ragged N,
    magnitudes above nb among the digits: every partial bucket in affine
    against the python-int sum of its slot's points n = j mod 3 whose
    digit selects it."""
    rng = np.random.default_rng(90 + signed)
    nb, n, w, m = (8 if signed else 15), 31, 2, 3
    digits = rng.integers(0, 64, (w, n))
    digits[0, :nb + 1] = np.arange(nb + 1)
    if signed:
        digits |= rng.integers(0, 2, (w, n)) << 6
    pick = rng.integers(0, len(_base_points()), n)
    affine = [_base_points()[i] for i in pick]
    p = _points(affine, [v + 1 for v in _rand(P - 1, n, rng)])
    got = K.msm_bucket_accumulate_all(
        torch.as_tensor(digits, dtype=torch.int32), *p, nb,
        signed_digits=signed, m_slots=m)
    assert got.shape == (w, nb, 3, 16, m)
    for wi in range(w):
        for b in range(nb):
            want = [None] * m
            for i in range(n):
                d = int(digits[wi, i])
                mag, neg = (d & 0x3F, d >> 6 == 1) if signed else (d, False)
                if mag == b + 1:
                    pt_i = affine[i]
                    if neg:
                        pt_i = (pt_i[0], P - pt_i[1])
                    want[i % m] = gold.affine_add(want[i % m], pt_i)
            assert _affine(pt.Point(*got[wi, b].unbind(0))) == want


def test_plain_bucket_walk_skips_magnitude_zero_with_the_sign_bit():
    """Signed digits with magnitude 0 and the sign bit set (1 << 6) pinned
    on lanes of window 0 and of window 1, beside plain zeros and the edge
    magnitudes 1 and nb with and without the sign: each such lane adds to
    no bucket, and every partial bucket equals in affine the python-int
    sum of its slot's points."""
    rng = np.random.default_rng(66)
    nb, n, w, m = 8, 24, 2, 4
    digits = rng.integers(0, nb + 1, (w, n)) | (rng.integers(0, 2, (w, n))
                                                << 6)
    digits[0, :6] = [1 << 6, 1 << 6, 0, 1 << 6, nb | 1 << 6, 1]
    digits[1, 8:14] = [1 << 6, 0, 1 << 6, 1 << 6, 1 | 1 << 6, nb]
    pick = rng.integers(0, len(_base_points()), n)
    affine = [_base_points()[i] for i in pick]
    p = _points(affine, [v + 1 for v in _rand(P - 1, n, rng)])
    got = K.msm_bucket_accumulate_all(
        torch.as_tensor(digits, dtype=torch.int32), *p, nb,
        signed_digits=True, m_slots=m)
    assert got.shape == (w, nb, 3, 16, m)
    for wi in range(w):
        for b in range(nb):
            want = [None] * m
            for i in range(n):
                d = int(digits[wi, i])
                if d & 0x3F == b + 1:
                    q = affine[i]
                    if d >> 6 == 1:
                        q = (q[0], P - q[1])
                    want[i % m] = gold.affine_add(want[i % m], q)
            assert _affine(pt.Point(*got[wi, b].unbind(0))) == want, (wi, b)


# ---------------------------------------------------------------------------
# Digits.
# ---------------------------------------------------------------------------

DIGIT_KS = [0, 1, N - 1, 2**256 - 2**32 - 978, 0x3F3F3F3F,
            int("80" * 32, 16) % N, int("1f" * 32, 16)]


@pytest.mark.parametrize("w", [2, 4, 8])
def test_digits_match_jax(w):
    ks = DIGIT_KS + _rand(N, 9)
    k_np = lb.int_to_limbs_batch(ks).astype(np.uint32)
    with jax.disable_jit():                  # eager: a fraction of a compile
        want = jmsm._digits(jnp.asarray(k_np), w)
    got = msm._digits(convert.plane_to_torch(k_np), w)
    assert got.dtype == torch.int32 and got.shape == (256 // w, len(ks))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("w", [5, 6])
def test_signed_digits_match_jax_and_recode(w):
    ks = DIGIT_KS + _rand(N, 9)
    k_np = lb.int_to_limbs_batch(ks).astype(np.uint32)
    want = jax.jit(jmsm._signed_digits, static_argnums=1)(jnp.asarray(k_np),
                                                          w)
    got = msm._signed_digits(convert.plane_to_torch(k_np), w)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    half = 1 << (w - 1)
    for k, col in zip(ks, got.t().tolist()):             # ls window first
        mags = [d & 0x3F for d in col]
        assert max(mags) <= half and all(d >> 6 <= 1 for d in col)
        assert sum((-(d & 0x3F) if d >> 6 else d) << (w * i)
                   for i, d in enumerate(col)) == k


# ---------------------------------------------------------------------------
# MSM against python ints.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(1, 4), (2, 4), (32, 4), (32, 2)])
def test_pippenger_matches_gold(n, w):
    ks, pts, pick = _case(n, 100 * n + w)
    got = msm.multi_scalar_mult(_plane(ks), _points(pts), w)
    assert _affine(got) == [_want(ks, pick)]


def test_pippenger_zero_scalars_give_the_identity():
    got = msm.multi_scalar_mult(_plane([0] * 8), _points(_base_points()), 4)
    assert pt.is_identity(got).tolist() == [True]


def test_pippenger_repeated_digits():
    """Every point shares each digit value: long segments in the scan."""
    ks = [int("1" * 64, 16)] * 16
    ks[3], ks[7] = 1, N - 1
    _, pts, pick = _case(16, 3)
    got = msm.multi_scalar_mult(_plane(ks), _points(pts), 4)
    assert _affine(got) == [_want(ks, pick)]


def test_bucket_path_known_discrete_log(monkeypatch):
    """2,048 points, so the bucket path runs (w = 4 by the automatic
    choice): points a_i * G of known a_i tiled over the lanes, a scalar of
    its own on each lane, so the sum is (sum_j k_j a_(j mod 8) mod n) * G."""
    monkeypatch.setattr(msm, "MSM_SLOTS", 8)
    n = 2048
    ks = _rand(N, n)
    pick = np.arange(n) % len(_base_logs())
    pts = _points([_base_points()[i] for i in pick])
    assert msm._fused_msm_ok(pts, 4)
    K.reset_counts()
    got = msm.multi_scalar_mult(_plane(ks), pts)
    assert K.PLAIN_CALLS["msm_bucket_accumulate_all"] == 1
    assert _affine(got) == [_want(ks, pick)]


def test_straus_matches_gold():
    ks, pts, pick = _case(8, 9)
    ks[2] = 0
    got = msm.multi_scalar_mult_straus(_plane(ks), _points(pts))
    assert _affine(got) == [_want(ks, pick)]


def test_lane_merge_matches_gold():
    """_lane_merge sums each bucket row's lane slots by a pairwise tree."""
    k, slots = 3, 256
    rng = np.random.default_rng(11)
    base = _base_points()
    pts = [[base[i] for i in rng.integers(0, len(base), slots)]
           for _ in range(k)]
    slab = torch.stack([torch.stack(list(_points(row))) for row in pts])
    rows = msm._lane_merge(slab)                         # [K, 3, 16]
    got = _affine(pt.Point(*rows.permute(1, 2, 0)))
    want = []
    for row in pts:
        acc = None
        for p in row:
            acc = gold.affine_add(acc, p)
        want.append(acc)
    assert got == want


# ---------------------------------------------------------------------------
# The window fold (msm_fold) against python ints and the launch loop.
# ---------------------------------------------------------------------------

def _fold_rows(case):
    """(window sums as int32 [W, 3, 16] rows with random Z, their affine
    points (None for the identity), window bits).  "w4": W = 4, w = 4;
    "w8": W = 3, w = 8; "edge", w = 4, least significant window first: B,
    B (equal consecutive sums), the identity (0, Z, 0), the identity
    (0, 1, 0), 16 A (equal to the accumulator at its add), A; "cancel",
    w = 4: C, -16 A (the accumulator's negation at its add), A."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    a, b, c = (gold.affine_mul(k, gold.GEN) for k in _rand(N - 1, 3, rng))
    if case in ("w4", "w8"):
        w, n = (4, 4) if case == "w4" else (8, 3)
        pts = [gold.affine_mul(k, gold.GEN) for k in _rand(N - 1, n, rng)]
    elif case == "edge":
        w, pts = 4, [b, b, None, None, gold.affine_mul(16, a), a]
    else:
        w, pts = 4, [c, gold.affine_mul(N - 16, a), a]
    zs = [v + 1 for v in _rand(P - 1, len(pts), rng)]
    xyz = [(0, 1 if i == 3 and case == "edge" else z, 0) if q is None
           else (q[0] * z % P, q[1] * z % P, z)
           for i, (q, z) in enumerate(zip(pts, zs))]
    rows = torch.stack([_plane([t[i] for t in xyz]).t() for i in range(3)],
                       dim=1).contiguous()
    return rows, pts, w


FOLD_CASES = ["w4", "w8", "edge", "cancel"]


@pytest.mark.parametrize("case", FOLD_CASES)
def test_plain_fold_matches_python_ints_and_the_launch_loop(case):
    """msm_fold_plain: the python-int Horner sum of the windows, and the
    projective X, Y, Z of the loop of point_double and point_add wrapper
    calls that combine_windows made before the fold was one kernel."""
    rows, pts, w = _fold_rows(case)
    K.reset_counts()
    got = msm.combine_windows(rows, w)
    assert K.PLAIN_CALLS["msm_fold"] == 1 and not any(K.LAUNCHES.values())
    assert K.PLAIN_CALLS["point_double"] == K.PLAIN_CALLS["point_add"] == 0
    want = None
    for q in pts[::-1]:
        for _ in range(w):
            want = gold.affine_add(want, want)
        want = gold.affine_add(want, q)
    assert _affine(got) == [want]
    acc = pt.identity((1,), "cpu")
    for wsum in rows.flip(0):
        for _ in range(w):
            acc = pt.double(acc)
        acc = pt.add(acc, pt.Point(*wsum.unsqueeze(-1)))
    assert all(torch.equal(g, a) for g, a in zip(got, acc))
    assert all(torch.equal(g, a) for g, a in
               zip(got, K.msm_fold_plain(rows, w)))


def test_fold_wrapper_checks_its_operands():
    rows, _, _ = _fold_rows("w8")
    with pytest.raises(ValueError, match="window sums"):
        K.msm_fold(rows.to(torch.int64), 8)
    with pytest.raises(ValueError, match="window_bits"):
        K.msm_fold(rows, 0)
    ident = K.msm_fold(rows[:0], 4)
    assert [int(c[0, 0]) for c in ident] == [0, 1, 0]


# ---------------------------------------------------------------------------
# Point and table helpers of the MSM path.
# ---------------------------------------------------------------------------

def test_point_add_and_double_take_their_wrappers():
    _, pts, _ = _case(6, 13)
    p = _points(pts, [v + 1 for v in _rand(P - 1, 6)])
    q = _points(pts[::-1])
    K.reset_counts()
    s, d = pt.add(p, q), pt.double(p)
    assert K.PLAIN_CALLS["point_add"] == 1 and K.PLAIN_CALLS["point_double"] == 1
    assert K.LAUNCHES["point_add"] == 0 and K.LAUNCHES["point_double"] == 0
    assert _affine(s) == [gold.affine_add(x, y) for x, y in zip(pts, pts[::-1])]
    assert _affine(d) == [gold.affine_add(x, x) for x in pts]
    for got, want in ((s, pt.add(p, q, fe.F_PLAIN)), (d, pt.double(p, fe.F_PLAIN))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _affine(pt.sub(p, q)) == [gold.affine_add(x, (y[0], P - y[1]))
                                     for x, y in zip(pts, pts[::-1])]
    assert pt.equal(p, _points(pts)).tolist() == [True] * 6
    assert pt.equal(p, q).tolist() == [x == y for x, y in zip(pts, pts[::-1])]
    meta = torch.empty((16, 6), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.point_add(*p, meta, meta, meta)
    with pytest.raises(ValueError):
        K.point_double(p.x[:, :3], p.y, p.z)
    with pytest.raises(ValueError):
        K.msm_bucket_accumulate_all(torch.zeros((2, 6), dtype=torch.int32),
                                    *p, n_buckets=0)


def test_lane_table_build_and_masked_lookup():
    _, pts, pick = _case(5, 17)
    p = _points(pts, [v + 1 for v in _rand(P - 1, 5)])
    table = tbl.build_lane_table(p)
    assert table.shape == (15, 3, 16, 5) and table.dtype == torch.int32
    digits = torch.tensor([0, 1, 2, 9, 15], dtype=torch.int32)
    sel = tbl.lookup_lane_table(table, digits)
    assert sel.x.dtype == torch.int32
    assert [int(v) for v in sel.z[:, 0]] == [0] * 16     # digit 0: zeros
    assert _affine(sel)[1:] == [
        gold.affine_mul(d * _base_logs()[i] % N, gold.GEN)
        for d, i in zip([1, 2, 9, 15], pick[1:])]
