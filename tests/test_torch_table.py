"""The port's fixed-base path against the JAX package and python ints.

The signed G table must equal the JAX package's bit for bit (through
`secp256k1_tpu_torch.convert`), the signed recoding must match JAX
`_signed_digits`, and the plain fixed-base function and
`scalar_base_mult_add` must give k*G + Q, and the all-windows lookup
`lookup_shared_affine_all` must equal the JAX one (plain XLA) and the
per-window `lookup_shared_affine`, stacked.  Tolerance 0 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.ops import table as jtbl
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = hc.P, hc.N
RNG = np.random.default_rng(4242)


def _rand(m, k):
    return [int.from_bytes(RNG.bytes(32), "big") % m for _ in range(k)]


# Recoding edge cases: all-0x80 windows (carry propagates through them),
# all-0xFF (every window negative), the top window's carry out.
PATTERN_KS = [0, 1, N - 1, int("80" * 32, 16) % N, int("7f" * 32, 16),
              int("ff" * 16, 16), 2**255, int("80" * 31 + "81", 16) % N]


def test_base_table_matches_jax_bit_for_bit():
    want = jtbl.gen_base_tables_signed_np(8)
    assert want.shape == (33, 128, 2, 16)
    port = tbl.base_table("cpu")
    assert port.dtype == torch.int32 and port.is_contiguous()
    assert np.array_equal(convert.table_from_torch(port), want)
    assert torch.equal(convert.table_to_torch(want), port)
    # Spot-check the contract: table[w][d-1] = d * 2^(8w) * G.
    for w, d in ((0, 1), (0, 128), (5, 77), (32, 1)):
        x = lb.limbs_to_int(want[w, d - 1, 0])
        y = lb.limbs_to_int(want[w, d - 1, 1])
        assert (x, y) == hc.mul(d << (8 * w), hc.G)


def test_signed_digits_matches_jax():
    ks = PATTERN_KS + _rand(N, 24)
    k_np = lb.int_to_limbs_batch(ks).astype(np.uint32)
    want = jax.jit(lambda k: jtbl._signed_digits(k, 8))(jnp.asarray(k_np))
    got = tbl._signed_digits(convert.plane_to_torch(k_np), 8)
    assert got.shape == (33, len(ks)) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for k, col in zip(ks, got.t().tolist()):      # least significant first
        val = sum((-(d & 0xFFFF) if d >> 16 else d) << (8 * w)
                  for w, d in enumerate(col))
        assert val == k


def _q_points(k):
    """Random multiples of G, with the identity on lane 1."""
    qs = [hc.mul(v, hc.G) for v in _rand(N, k)]
    qs[1] = None
    return qs


def _proj(points):
    zs = [v + 1 for v in _rand(P - 1, len(points))]
    trip = [(0, z, 0) if a is None else (a[0] * z % P, a[1] * z % P, z)
            for a, z in zip(points, zs)]
    return pt.Point(*[torch.as_tensor(lb.int_to_limbs_batch(
        [t[i] for t in trip]), dtype=torch.int32) for i in range(3)])


def _affine(point):
    out = []
    for x, y, z in zip(*(lb.limbs_to_int_batch(c) for c in point)):
        out.append(None if z == 0 else
                   (x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P))
    return out


@pytest.mark.parametrize("via", ["plain", "scalar_base_mult_add"])
def test_fixed_base_against_python_ints(via):
    ks = PATTERN_KS + _rand(N, 8)
    qs = _q_points(len(ks))
    qs[0] = hc.neg(hc.mul(ks[3], hc.G))
    ks[0] = ks[3]                                 # k*G + (-k*G) = identity
    k_t = torch.as_tensor(lb.int_to_limbs_batch(ks), dtype=torch.int32)
    q = _proj(qs)
    K.reset_counts()
    if via == "plain":
        digits = tbl._signed_digits(k_t)
        # A magnitude-0 digit with the sign bit set is still zero.
        zero = (digits & 0xFFFF) == 0
        assert bool(zero[0].any()) and bool(zero[1:].any())
        digits = torch.where(zero, digits | (1 << 16), digits)
        got = K.base_windowed_add_final_plain(digits, tbl.base_table("cpu"),
                                              *q)
    else:
        got = tbl.scalar_base_mult_add(k_t, q)
        assert K.PLAIN_CALLS["base_windowed_add_final"] == 1
        assert K.LAUNCHES["base_windowed_add_final"] == 0
    assert all(c.dtype == torch.int32 for c in got)
    want = [hc.add(hc.mul(k, hc.G), qv) for k, qv in zip(ks, qs)]
    assert want[0] is None
    assert _affine(got) == want


@pytest.mark.parametrize("budget", [1 << 30, 4 * 8 * 64 + 1],
                         ids=["one-chunk", "window-a-chunk"])
def test_lookup_shared_affine_all_matches_jax(budget):
    """W = 4 windows of E = 8 random entries, 64 lanes, digits 0 and E
    planted; a budget of one window's one-hot operand makes a chunk a
    window."""
    w, e, lanes = 4, 8, 64
    rng = np.random.default_rng(77)
    tables = rng.integers(0, 1 << 16, (w, e, 2, 16)).astype(np.uint32)
    digits = rng.integers(0, e + 1, (w, lanes)).astype(np.int32)
    digits[:, :3] = [0, e, 1]
    digits[2, 10:20] = 0
    digits[3, 20:30] = e
    want = jtbl.lookup_shared_affine_all(jnp.asarray(tables),
                                         jnp.asarray(digits))
    got = tbl.lookup_shared_affine_all(convert.table_to_torch(tables),
                                       torch.as_tensor(digits),
                                       onehot_budget=budget)
    for g, j in zip(got, want):
        assert g.shape == (w, 16, lanes) and g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(j).astype(np.int64))
    tab_t = convert.table_to_torch(tables)
    for k in range(w):
        one = tbl.lookup_shared_affine(tab_t[k], torch.as_tensor(digits[k]))
        assert torch.equal(got[0][k], one[0])
        assert torch.equal(got[1][k], one[1])
    assert not bool(got[0][:, :, 0].any())           # digit 0: the zero row
    assert np.array_equal(got[0][:, :, 1].numpy(), tables[:, e - 1, 0])
