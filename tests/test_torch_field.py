"""The port's limb algebra and modular rings against the JAX package.

Seeded numpy inputs go through `secp256k1_tpu_torch.convert` to both
packages; every comparison is exact (tolerance 0: these are residues).  The
JAX side runs as its own CPU tests run it: Pallas is off on the CPU, so
`ModRing` takes the jnp limb path, and the Pallas bodies `_mul_rows` and
`_sqr_rows` run eagerly under `jax.disable_jit()`.  Inversion and square
roots are held against python ints (a jitted JAX `S.invert` takes about a
minute to compile on the CPU).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.ops import field as jfe
from secp256k1_tpu.ops import limbs as jlb
from secp256k1_tpu.ops import scalar as jsc
from secp256k1_tpu.ops.pallas import kernels as pk
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import scalar as sc
from secp256k1_tpu_torch.ops.cuda import kernels as K

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

P, N = fe.P, sc.N
RINGS = {"p": (fe.F, jfe.F, P), "n": (sc.S, jsc.S, N)}


def _ints(rng, m, k):
    return [int.from_bytes(rng.bytes(32), "big") % m for _ in range(k)]


def _vals(m, k=64, seed=7):
    """Edge values of tests/test_kernel_bodies.py, then seeded randoms."""
    edge = [0, 1, 2, m - 1, m - 2, 2**255 % m, (m >> 1) + 1]
    return edge + _ints(np.random.default_rng(seed), m, k - len(edge))


def _np(vals, n_limbs=16):
    return jlb.int_to_limbs_batch(vals, n_limbs)       # [L, B] uint32


def _t(arr):
    return convert.plane_to_torch(arr)


def _same(t, j):
    return np.array_equal(convert.plane_from_torch(t), np.asarray(j))


# ---------------------------------------------------------------------------
# Limb primitives.
# ---------------------------------------------------------------------------

def _limb_case(name, rng):
    """(jax_fn, torch_fn, numpy args) for one limb primitive."""
    a = _np(_ints(rng, 2**256, 40))
    b = _np(_ints(rng, 2**256, 40))
    c9 = jsc.S.c_limbs
    if name == "carry_prop":
        cols = rng.integers(0, 2**32 - 2**16, size=(20, 40), dtype=np.uint32)
        return (lambda x: jlb.carry_prop(x, 22),
                lambda x: lb.carry_prop(x, 22), [cols])
    if name == "carry_prop_truncate":
        cols = rng.integers(0, 2**32 - 2**16, size=(20, 40), dtype=np.uint32)
        return (lambda x: jlb.carry_prop(x, 12),
                lambda x: lb.carry_prop(x, 12), [cols])
    if name == "add":
        return jlb.add, lb.add, [a, b[:9]]
    if name == "add_raw":
        return jlb.add_raw, lb.add_raw, [a, b[:5]]
    if name == "mul_wide":
        return jlb.mul_wide, lb.mul_wide, [a, b]
    if name == "square_wide":
        return jlb.square_wide, lb.square_wide, [a]
    if name == "mul_word":
        return (lambda x: jlb.mul_word(x, 21),
                lambda x: lb.mul_word(x, 21), [a])
    if name == "mul_const":
        return (lambda x: jlb.mul_const(x, c9),
                lambda x: lb.mul_const(x, c9), [a])
    if name == "sub_borrow":
        return jlb.sub_borrow, lb.sub_borrow, [a, b]
    if name == "cond_sub":
        m = jsc.S.m_limbs
        x = _np(_ints(rng, 2**256, 38) + [N, N - 1])
        return (lambda x: jlb.cond_sub(x, m),
                lambda x: lb.cond_sub(x, m), [x])
    if name == "geq_const":
        m = jfe.F.m_limbs
        x = _np(_ints(rng, 2**256, 38) + [P, P - 1])
        return (lambda x: jlb.geq_const(x, m),
                lambda x: lb.geq_const(x, m), [x])
    if name == "is_zero_eq_select":
        z = a.copy()
        z[:, :5] = 0
        mask = rng.integers(0, 2, size=(40,)).astype(bool)
        return (lambda x, y: (jlb.is_zero(x), jlb.eq(x, y),
                              jlb.select(jnp.asarray(mask), x, y)),
                lambda x, y: (lb.is_zero(x), lb.eq(x, y),
                              lb.select(torch.as_tensor(mask), x, y)),
                [z, np.where(mask[None], z, b)])
    if name == "mod_fold_p":
        wide = np.asarray(jlb.mul_wide(jnp.asarray(a), jnp.asarray(b)))
        return (lambda x: jlb.mod_fold(x, jfe.F.c_limbs),
                lambda x: lb.mod_fold(x, jfe.F.c_limbs), [wide])
    if name == "mod_fold_n":
        wide = np.asarray(jlb.mul_wide(jnp.asarray(a), jnp.asarray(b)))
        return (lambda x: jlb.mod_fold(x, c9),
                lambda x: lb.mod_fold(x, c9), [wide])
    raise KeyError(name)


LIMB_CASES = ["carry_prop", "carry_prop_truncate", "add", "add_raw",
              "mul_wide", "square_wide", "mul_word", "mul_const",
              "sub_borrow", "cond_sub", "geq_const", "is_zero_eq_select",
              "mod_fold_p", "mod_fold_n"]


@pytest.mark.parametrize("name", LIMB_CASES)
def test_limb_primitive_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    jfn, tfn, args = _limb_case(name, rng)
    want = jax.jit(jfn)(*[jnp.asarray(x) for x in args])
    # int64: carry_prop's column sums exceed the int32 storage type.
    got = tfn(*[convert.plane_to_torch(x, dtype=torch.int64)
                if x.dtype != bool else torch.as_tensor(x) for x in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


def test_host_limb_conversions():
    vals = _vals(N, 16)
    arr = lb.int_to_limbs_batch(vals)
    assert np.array_equal(arr, jlb.int_to_limbs_batch(vals).astype(np.int64))
    assert lb.limbs_to_int_batch(arr) == vals
    assert lb.limbs_to_int_batch(torch.as_tensor(arr)) == vals
    with pytest.raises(ValueError):
        lb.int_to_limbs(2**256)


# ---------------------------------------------------------------------------
# ModRing ops for p and n.
# ---------------------------------------------------------------------------

RING_OPS = ["add", "sub", "neg", "mul", "square", "pow2k1", "pow2k2",
            "pow2k5", "mul_word", "from_bytes_any", "to_bytes", "gt_half",
            "is_odd_cneg"]


def _ring_inputs(m):
    raw = np.random.default_rng(13).integers(0, 256, size=(32, 64),
                                             dtype=np.uint8)
    raw[:, :4] = 0xFF                     # >= m: reduced, did_reduce set
    raw[:, 4] = 0
    return _np(_vals(m, 64, seed=11)), _np(_vals(m, 64, seed=12)[::-1]), raw


def _ring_ops(r, a, b, raw):
    """Every op of RING_OPS on one ring: {op: array or tuple}."""
    odd = r.is_odd(a)
    return {"add": r.add(a, b), "sub": r.sub(a, b), "neg": r.neg(a),
            "mul": r.mul(a, b), "square": r.square(a),
            "pow2k1": r.pow2k(a, 1), "pow2k2": r.pow2k(a, 2),
            "pow2k5": r.pow2k(a, 5), "mul_word": r.mul_word(a, 21),
            "from_bytes_any": r.from_bytes_any(raw),
            "to_bytes": r.to_bytes(a), "gt_half": r.gt_half(a),
            "is_odd_cneg": (odd, r.cneg(odd, b))}


@functools.cache
def _jax_ring_results(ring):
    """All JAX ring ops of one ring in a single jit (one compile)."""
    _, jr, m = RINGS[ring]
    a, b, raw = _ring_inputs(m)
    out = jax.jit(lambda x, y, z: _ring_ops(jr, x, y, z))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(raw))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("ring", ["p", "n"])
@pytest.mark.parametrize("op", RING_OPS)
def test_ring_op_matches_jax(ring, op):
    tr, _, m = RINGS[ring]
    a, b, raw = _ring_inputs(m)
    want = _jax_ring_results(ring)[op]
    got = _ring_ops(tr, _t(a), _t(b), torch.as_tensor(raw))[op]
    if op == "from_bytes_any":                # (element, did_reduce)
        assert np.array_equal(got[1].numpy(), want[1])
        assert bool(got[1][:4].all())
        got, want = got[0], want[0]
    elif op == "is_odd_cneg":                 # (mask, cneg(mask, b))
        assert np.array_equal(got[0].numpy(), want[0])
        got, want = got[1], want[1]
    elif op == "gt_half":
        assert np.array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.int32
    assert _same(got, want)


# ---------------------------------------------------------------------------
# The plain kernel functions against the Pallas bodies and python ints.
# ---------------------------------------------------------------------------

def _rows(vals):
    plane = _np(vals)                                  # [16, 256]
    return [jnp.asarray(plane[i].reshape(2, 128)) for i in range(16)]


@pytest.mark.parametrize("ring", ["p", "n"])
@pytest.mark.parametrize("body", ["mul", "sqr"])
def test_plain_mod_kernels_match_pallas_bodies(ring, body):
    m = RINGS[ring][2]
    c_limbs, m17 = (pk._CP, pk._M17P) if m == P else (pk._CN, pk._M17N)
    a = _vals(m, 256, seed=21)
    b = _vals(m, 256, seed=22)[::-1]
    with jax.disable_jit():
        if body == "mul":
            rows = pk._mul_rows(_rows(a), _rows(b), c_limbs, m17)
            got = K.mod_mul_plain(_t(_np(a)), _t(_np(b)), m)
        else:
            rows = pk._sqr_rows(_rows(a), c_limbs, m17)
            got = K.mod_square_plain(_t(_np(a)), m)
        want = np.stack([np.asarray(r).reshape(256) for r in rows], axis=0)
    assert _same(got, want)
    expect = [x * y % m for x, y in zip(a, b)] if body == "mul" \
        else [x * x % m for x in a]
    assert lb.limbs_to_int_batch(got) == expect


@pytest.mark.parametrize("ring", ["p", "n"])
def test_plain_pow2k_and_wrappers(ring):
    tr, _, m = RINGS[ring]
    a = _vals(m, 32, seed=23)
    t = _t(_np(a))
    K.reset_counts()
    for k in (2, 5, 9):
        got = K.mod_pow2k(t, k, m)
        assert lb.limbs_to_int_batch(got) == [pow(x, 2**k, m) for x in a]
    assert K.PLAIN_CALLS["mod_pow2k"] == 3
    assert K.LAUNCHES["mod_pow2k"] == 0


CHAINS = {"p-2": (P - 2, P), "n-2": (N - 2, N), "(p-3)/4": ((P - 3) // 4, P)}


@pytest.mark.parametrize("lanes", [1, 257])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plain_pow_chain_matches_python_ints(name, lanes):
    """mod_pow_chain_plain for the exponents of invert and the square
    root: the edge values and random ones in a 257-lane batch; 0, m - 1
    and a random value each alone in a one-lane batch (the root of
    invert_batch)."""
    e, m = CHAINS[name]
    vals = _vals(m, 257, seed=61)
    batches = [vals] if lanes > 1 else [[0], [m - 1], [vals[-1]]]
    for batch in batches:
        got = K.mod_pow_chain_plain(_t(_np(batch)), e, m)
        assert got.shape == (16, len(batch)) and got.dtype == torch.int32
        assert lb.limbs_to_int_batch(got) == [pow(x, e, m) for x in batch]


def test_pow_const_chain_takes_the_chain_wrapper():
    """pow_const_chain is one mod_pow_chain call (its plain version on CPU
    tensors, no mod_pow2k or mod_mul of its own); the plain ring runs the
    plain chain directly; mod_pow2k is the one-step chain of 2^k."""
    a = _t(_np(_vals(P, 16, seed=62)))
    e = (P - 3) // 4
    K.reset_counts()
    got = fe.F.pow_const_chain(a, e)
    assert K.PLAIN_CALLS["mod_pow_chain"] == 1
    assert sum(K.PLAIN_CALLS.values()) == 1 and not any(K.LAUNCHES.values())
    assert torch.equal(got, fe.F_PLAIN.pow_const_chain(a, e))
    assert sum(K.PLAIN_CALLS.values()) == 1
    steps = K.pow_chain_steps(P - 2)
    assert sum(k for _, k, _, _ in steps) == 261       # 255 at the least
    steps = K.pow_chain_steps(N - 2)
    assert steps == K.pow_chain_steps(N - 2)           # e alone decides
    assert K.pow_chain_steps(1 << 9) == ((0, 9, K.POW_ACC, K.POW_ACC),)
    squarings = sum(k for _, k, _, _ in steps)
    multiplies = sum(mul != K.POW_ACC for _, _, mul, _ in steps)
    assert (len(steps), squarings, multiplies) == (46, 309, 46)
    with pytest.raises(ValueError):
        K.pow_chain_steps(0)


@pytest.mark.parametrize("ring", ["p", "n"])
def test_invert_against_python_ints(ring):
    tr, _, m = RINGS[ring]
    a = _vals(m, 24, seed=31)
    got = tr.invert(_t(_np(a)))
    assert lb.limbs_to_int_batch(got) == [pow(x, m - 2, m) for x in a]


@pytest.mark.parametrize("ring", ["p", "n"])
@pytest.mark.parametrize("width", [1, 2, 5, 37, 64])
def test_invert_batch_against_python_ints(ring, width):
    tr, _, m = RINGS[ring]
    a = _vals(m, 64, seed=32 + width)[:width]
    if width > 2:
        a[width // 2] = 0                   # zero lanes map to 0
    got = tr.invert_batch(_t(_np(a)))
    assert got.shape == (16, width)
    assert lb.limbs_to_int_batch(got) == [pow(x, m - 2, m) for x in a]


def test_invert_auto_switches_at_2048_lanes():
    a = _vals(N, 8, seed=41)
    t = _t(_np(a))
    assert torch.equal(sc.S.invert_auto(t, min_batch=8), sc.S.invert(t))


def test_sqrt_against_python_ints():
    a = _vals(P, 48, seed=51)
    got, ok = fe.sqrt(_t(_np(a)))
    roots = lb.limbs_to_int_batch(got)
    for x, r, is_sq in zip(a, roots, ok.tolist()):
        want_sq = pow(x, (P - 1) // 2, P) in (0, 1)
        assert is_sq == want_sq
        if is_sq:
            assert r * r % P == x
        else:
            assert r == 0
