"""The port's alternative engines against python ints and each other.

The kernels behind the JAX package's engine switches, through their plain
versions on the CPU (tolerance 0 throughout):

- `point_double4`, `point_add_mixed`, `point_lookup_add`,
  `glv_windowed_mult_from_points` (#7) and `glv_windowed_mult` (#9)
  against python-int curve arithmetic and the composed formulas;
- the not-mega GLV route (`set_mega(False)`: lane tables, `double_n` and
  `point_lookup_add`) gives the projective X, Y, Z of #9 fed the same
  tables and digits, the schedule both share; #7 and the signed #4 give
  the same affine point (the routes of the switches give the same ECDH
  bytes in `tests/test_torch_ecdh.py`);
- `point.double_n` and `point.add_mixed` reach their kernels' wrappers;
- `limbs.carry_chain` across 65 windows and `table._signed_digits` at
  every width 4-15 against python ints;
- the fixed-base routes at `set_base_signed(False)` and
  `set_base_window(w)` for w in 4, 5, 6, 12 against `hc.mul`, and the
  switches restored afterwards.
"""

import functools

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import glv
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference_mode():
    """No autograd bookkeeping: the plain loops dispatch thousands of small
    ops, and inference mode takes about a quarter off each."""
    with torch.inference_mode():
        yield

P, N = hc.P, hc.N
LANES = 8
RNG = np.random.default_rng(20261017)


def _rand(m, k, rng=RNG):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


_POINTS = [hc.mul(k, hc.G) for k in _rand(N - 1, LANES)]
_ZS = [z + 1 for z in _rand(P - 1, LANES)]


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=lb.DTYPE)


def _proj(points, zs=_ZS):
    """Affine points (None = identity) -> a projective Point with the given
    Z per lane."""
    trip = [(0, z, 0) if a is None else (a[0] * z % P, a[1] * z % P, z)
            for a, z in zip(points, zs)]
    return pt.Point(*(_plane([t[i] for t in trip]) for i in range(3)))


def _affine(planes):
    xs, ys, zs = (lb.limbs_to_int_batch(c) for c in planes)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, P)
            out.append((x * zi % P, y * zi % P))
    return out


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


GLV_TEST_WINDOWS = 8      # 32-bit short scalars keep the plain loops short


@functools.cache
def _glv_case():
    """Short scalars of GLV_TEST_WINDOWS nibbles and points, with edge
    digits: lane 0 has digit 0 in window 0 of k1, lane 1 all-zero k1
    digits, lane 2 all-15 k1 and k2 digits, lane 3 k2 = 0.  Returns
    (k1s, k2s, p1s, p2s, d1, d2, P1, P2, t1, t2)."""
    bits = 4 * GLV_TEST_WINDOWS
    k1s = [int.from_bytes(RNG.bytes(16), "big") >> (128 - bits)
           for _ in range(LANES)]
    k2s = [int.from_bytes(RNG.bytes(16), "big") >> (128 - bits)
           for _ in range(LANES)]
    k1s[0] &= (1 << (bits - 4)) - 1
    k1s[1] = 0
    k1s[2] = k2s[2] = (1 << bits) - 1
    k2s[3] = 0
    p1s = _POINTS
    p2s = _POINTS[3:] + _POINTS[:3]
    d1 = glv._nibble_digits_128(_plane(k1s))[-GLV_TEST_WINDOWS:]
    d2 = glv._nibble_digits_128(_plane(k2s))[-GLV_TEST_WINDOWS:]
    p1, p2 = _proj(p1s), _proj(p2s, _ZS[::-1])
    return (k1s, k2s, p1s, p2s, d1.contiguous(), d2.contiguous(), p1, p2,
            tbl.build_lane_table(p1), tbl.build_lane_table(p2))


def _glv_want(k1s, k2s, p1s, p2s):
    return [hc.add(hc.mul(a, p), hc.mul(b, q))
            for a, b, p, q in zip(k1s, k2s, p1s, p2s)]


def test_nibble_digits_are_the_scalar_most_significant_first():
    ks = _rand(1 << 128, LANES)
    ks[0] &= (1 << 124) - 1
    d = glv._nibble_digits_128(_plane(ks))
    assert d.shape == (32, LANES) and d.dtype == torch.int32
    for lane, k in enumerate(ks):
        assert sum(int(d[i, lane]) << (4 * (31 - i))
                   for i in range(32)) == k
    assert int(d[0, 0]) == 0


def test_point_double4_plain_is_four_doublings():
    p = _proj(_POINTS[:-1] + [None])
    got = K.point_double4_plain(*p)
    assert _affine(got) == [hc.mul(16, a) if a else None
                            for a in _POINTS[:-1] + [None]]
    want = p
    for _ in range(4):
        want = pt.double(want, fe.F_PLAIN)
    assert _same(got, want)


def test_point_add_mixed_plain_against_python_ints():
    q = _POINTS[1:] + _POINTS[:1]
    q[0] = _POINTS[0]                          # P == Q: a doubling
    q[1] = hc.neg(_POINTS[1])                  # P == -Q: the identity
    a = list(_POINTS)
    a[2] = None                                # P the identity
    got = K.point_add_mixed_plain(*_proj(a), _plane([x for x, _ in q]),
                                  _plane([y for _, y in q]))
    assert _affine(got) == [hc.add(x, y) for x, y in zip(a, q)]


def test_point_lookup_add_plain_against_python_ints():
    acc_pts = _POINTS[2:] + _POINTS[:2]
    acc_pts[3] = None                          # the identity + an entry
    acc = _proj(acc_pts, _ZS[::-1])
    base = _proj(_POINTS)
    table = tbl.build_lane_table(base)
    assert table.shape == (15, 3, 16, LANES)
    digits = torch.tensor([0, 1, 2, 15, 7, 0, 14, 9], dtype=torch.int32)
    got = K.point_lookup_add_plain(*acc, table, digits)
    want = [hc.add(a, hc.mul(int(d), b)) if d else a
            for a, b, d in zip(acc_pts, _POINTS, digits)]
    assert _affine(got) == want
    keep = digits == 0                         # digit 0: X, Y, Z passed
    for g, a in zip(got, acc):
        assert torch.equal(g[:, keep], a[:, keep])
    # The formula: a gather of table[d - 1], a complete add, a select.
    sel = table[(digits - 1).clamp(min=0).long(), :, :,
                torch.arange(LANES)]                # [B, 3, 16]
    added = pt.add(acc, pt.Point(*sel.permute(1, 2, 0)), fe.F_PLAIN)
    assert _same(got, pt.select(keep, acc, added))


@functools.cache
def _glv_plain_results():
    """#7's and #9's plain versions on `_glv_case`: (from points, from
    tables)."""
    _, _, _, _, d1, d2, p1, p2, t1, t2 = _glv_case()
    return (K.glv_windowed_mult_from_points_plain(d1, d2, p1, p2),
            K.glv_windowed_mult_plain(d1, d2, t1, t2))


def test_glv_from_points_plain_against_python_ints():
    k1s, k2s, p1s, p2s = _glv_case()[:4]
    got = _glv_plain_results()[0]
    assert _affine(got) == _glv_want(k1s, k2s, p1s, p2s)


def test_glv_tables_plain_against_python_ints():
    k1s, k2s, p1s, p2s = _glv_case()[:4]
    got = _glv_plain_results()[1]
    assert _affine(got) == _glv_want(k1s, k2s, p1s, p2s)


def test_not_mega_route_has_the_prebuilt_table_schedule():
    """The loop that glv.scalar_mult takes under set_mega(False) equals
    #9's plain version fed the same tables and digits, in X, Y, Z
    (identity start, double_n -> point_double4, lookup-add, lookup-add),
    and k1*P1 + k2*P2 in affine; GLV_TEST_WINDOWS windows keep it short.
    The route itself, at 32 windows, is held against the default engine
    by tests/test_torch_ecdh.py."""
    k1s, k2s, p1s, p2s, d1, d2, _, _, t1, t2 = _glv_case()
    K.reset_counts()
    got = glv.lane_table_mult(d1, d2, t1, t2)
    calls = dict(K.PLAIN_CALLS)
    assert _same(got, _glv_plain_results()[1])
    assert calls["point_double4"] == GLV_TEST_WINDOWS
    assert calls["point_lookup_add"] == 2 * GLV_TEST_WINDOWS
    assert calls["glv_windowed_mult"] == 0
    assert _affine(got) == _glv_want(k1s, k2s, p1s, p2s)


def test_unsigned_glv_matches_the_signed_kernel_in_affine():
    """#7 on nibble digits and #4 on the signed recoding of the same short
    scalars give the same affine k1*P1 + k2*P2; their projective X, Y, Z
    differ (other tables, other digits)."""
    k1s, k2s, p1s, p2s, d1, d2, p1, p2, _, _ = _glv_case()
    unsigned = _glv_plain_results()[0]

    def signed(ks):
        raw = tbl._raw_digits(_plane(ks)[:8], 4, GLV_TEST_WINDOWS)
        return tbl.signed_recode(raw, 4, 4).flip(0).contiguous()
    s1, s2 = signed(k1s), signed(k2s)
    assert s1.shape == (GLV_TEST_WINDOWS + 1, LANES)
    got = K.glv_windowed_mult_signed_from_points_plain(s1, s2, p1, p2)
    assert _affine(got) == _affine(unsigned)
    assert _affine(got) == _glv_want(k1s, k2s, p1s, p2s)
    assert not _same(got, unsigned)


def test_double_n_and_add_mixed_reach_their_kernels():
    p = _proj(_POINTS)
    K.reset_counts()
    got4 = pt.double_n(p, 8)
    assert K.PLAIN_CALLS["point_double4"] == 2
    assert K.PLAIN_CALLS["point_double"] == 0
    got3 = pt.double_n(p, 3)
    assert K.PLAIN_CALLS["point_double"] == 3
    assert _affine(got4) == [hc.mul(256, a) for a in _POINTS]
    assert _affine(got3) == [hc.mul(8, a) for a in _POINTS]
    q = _POINTS[::-1]
    mixed = pt.add_mixed(p, _plane([x for x, _ in q]),
                         _plane([y for _, y in q]))
    assert K.PLAIN_CALLS["point_add_mixed"] == 1
    assert K.PLAIN_CALLS["mod_mul"] == 0
    assert _affine(mixed) == [hc.add(a, b) for a, b in zip(_POINTS, q)]


@pytest.mark.parametrize("n_windows", [1, 61, 62, 63, 65, 130])
def test_carry_chain_spans_any_window_count(n_windows):
    rng = np.random.default_rng(n_windows)
    lanes = 64
    kind = rng.integers(0, 3, size=(n_windows, lanes))
    kind[:, 0] = 2                              # a carry through every window
    kind[0, 0] = 1
    kind[:, 1] = 2
    gen = torch.as_tensor(kind == 1, dtype=torch.int64)
    prop = torch.as_tensor(kind == 2, dtype=torch.int64)
    cin, cout = lb.carry_chain(gen, prop)
    assert cin.shape == (n_windows, lanes) and cout.shape == (lanes,)
    for lane in range(lanes):
        c = 0
        for i in range(n_windows):
            assert int(cin[i, lane]) == c
            c = int(gen[i, lane]) | (int(prop[i, lane]) & c)
        assert int(cout[lane]) == c
    assert int(cout[0]) == 1 and int(cout[1]) == 0


_PATTERN_KS = [0, 1, 2, N - 1, N - 2, 2**255 % N, (N >> 1) + 1,
               int("80" * 32, 16) % N, int("ff" * 16, 16), 2**255,
               int("7f" * 32, 16)]


def _signed_digits_int(k, w):
    """Python-int signed recoding, least significant window first."""
    n_windows = -(-256 // w)
    out, carry = [], 0
    for i in range(n_windows):
        t = ((k >> (w * i)) & ((1 << w) - 1)) + carry
        neg = t > 1 << (w - 1)
        out.append(((1 << w) - t if neg else t) | (int(neg) << 16))
        carry = int(neg)
    return out + [carry]


@pytest.mark.parametrize("w", range(4, 16))
def test_signed_digits_every_width_against_python_ints(w):
    ks = _PATTERN_KS + _rand(N, 8)
    got = tbl._signed_digits(_plane(ks), w)
    assert got.shape == (-(-256 // w) + 1, len(ks))
    assert got.dtype == torch.int32
    for lane, k in enumerate(ks):
        digits = [int(v) for v in got[:, lane]]
        assert digits == _signed_digits_int(k, w)
        assert sum((d & 0xFFFF) * (-1) ** (d >> 16) << (w * i)
                   for i, d in enumerate(digits)) == k


_BASE_KS = [1, N - 1, int("80" * 32, 16) % N, 2**255 % N] + _rand(N, 4)


@pytest.mark.parametrize("signed,window", [(False, 8), (True, 4), (True, 5),
                                           (True, 6), (True, 12)])
def test_fixed_base_routes_against_python_ints(signed, window):
    """scalar_base_mult_add under each switch; Q is the identity on two
    lanes, so those lanes read k*G itself.  Off the fused final kernel the
    sum is add(scalar_base_mult(k), Q), the whole k*G route; on it,
    scalar_base_mult's own kernel is checked too."""
    k = _plane(_BASE_KS)
    q_pts = list(_POINTS)
    q_pts[1] = q_pts[5] = None
    q = _proj(q_pts)
    try:
        tbl.set_base_signed(signed)
        tbl.set_base_window(window)
        K.reset_counts()
        got_add = tbl.scalar_base_mult_add(k, q)
        calls = dict(K.PLAIN_CALLS)
        fused_final = calls["base_windowed_add_final"] == 1
        got = tbl.scalar_base_mult(k) if fused_final else None
    finally:
        tbl.set_base_signed(True)
        tbl.set_base_window(8)
    want = [hc.mul(v, hc.G) for v in _BASE_KS]
    assert _affine(got_add) == [hc.add(a, b) for a, b in zip(want, q_pts)]
    fused = tbl._fused_base_ok(window, signed)
    assert fused_final == (signed and fused)
    if fused_final:
        assert _affine(got) == want
    else:
        n_windows = -(-256 // window) + 1 if signed else 32
        assert calls["point_add"] == 1
        assert calls["base_windowed_add"] == int(fused)
        assert calls["point_add_mixed"] == (0 if fused else n_windows)
    assert tbl.base_signed_enabled() and tbl.base_window() == 8


def test_unsigned_4bit_fixed_base_takes_the_scan():
    k = _plane(_BASE_KS)
    K.reset_counts()
    got = tbl.scalar_base_mult(k, 4)
    assert K.PLAIN_CALLS["point_add_mixed"] == 64
    assert K.PLAIN_CALLS["base_windowed_add"] == 0
    assert _affine(got) == [hc.mul(v, hc.G) for v in _BASE_KS]


def test_fused_rule_and_unsigned_tables():
    assert [w for w in range(4, 16) if tbl._fused_base_ok(w, True)] \
        == list(range(6, 16))
    assert tbl._fused_base_ok(8) and not tbl._fused_base_ok(4)
    t8 = tbl.gen_base_tables_np(8)
    assert t8.shape == (32, 255, 2, 16)
    for w, d in ((0, 1), (0, 255), (31, 200)):
        xy = tuple(lb.limbs_to_int(t8[w, d - 1, c]) for c in range(2))
        assert xy == hc.mul(d << (8 * w), hc.G)
    t4 = tbl.base_table("cpu", 4, signed=False)
    assert t4.shape == (64, 15, 2, 16) and t4.dtype == torch.int32


def test_lane_table_converter_round_trips_the_jax_layout():
    table = tbl.build_lane_table(_proj(_POINTS))
    wide = torch.cat([table] * 32, dim=3)           # 256 lanes
    tiled = convert.lane_table_from_torch(wide, tiled=True)
    assert tiled.shape == (15, 3, 16, 2, 128) and tiled.dtype == np.uint32
    assert torch.equal(convert.lane_table_to_torch(tiled), wide)
    assert torch.equal(convert.lane_table_to_torch(
        convert.lane_table_from_torch(table)), table)


def test_switches_default_on_and_restore():
    assert K.mega_enabled() and K.mega_signed_enabled()
    assert tbl.base_signed_enabled() and tbl.base_window() == 8
    with pytest.raises(AssertionError):
        tbl.set_base_window(16)
    assert tbl.base_window() == 8
