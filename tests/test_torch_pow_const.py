"""`pow_const` and `pow_const_chain` for every exponent, and the ring
aliases of `field` and `scalar`, on the CPU.

- Both methods on both rings against python `pow` at exponents of up to
  5,001 bits, m - 1, m and m + 1, on the edge values of
  `tests/test_kernel_bodies.py` (python `pow` is the oracle here: the JAX
  `pow_const` at 5,000 bits would cost the suite minutes of eager JAX).
- The exponent is reduced to e' = ((e - 1) mod (m - 1)) + 1 before its
  chain is built, so an e in [1, m - 1] reaches the chain wrapper as it is
  (one call for the exponents of the paths) and every other e as e'.
- The module aliases `pow_const`, `bytes_are_canonical` and (of `scalar`)
  `from_wide_bytes` against the JAX module's functions.

Tolerance 0: results are bit-exact.
"""

import random

import numpy as np
import pytest
import torch

import gold
from secp256k1_tpu.ops import field as jfe
from secp256k1_tpu.ops import limbs as jlb
from secp256k1_tpu.ops import scalar as jsc
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import modring
from secp256k1_tpu_torch.ops import scalar as sc
from secp256k1_tpu_torch.ops.cuda import kernels as K

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

RNG = random.Random(1111)
RINGS = {"p": (fe.F, gold.P), "n": (sc.S, gold.N)}


@pytest.fixture(autouse=True)
def _no_autograd():
    with torch.inference_mode():
        yield


def _edge(m):
    return [0, 1, 2, m - 1, m - 2, 2**255 % m, (m >> 1) + 1]


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=lb.DTYPE)


def _exponents(m):
    return [2**4096, 2**5000 + 1, m - 1, m, m + 1, 2**512 - 1]


@pytest.mark.parametrize("method", ["pow_const", "pow_const_chain"])
@pytest.mark.parametrize("ring_id", sorted(RINGS))
def test_every_exponent_matches_python_pow(ring_id, method):
    ring, m = RINGS[ring_id]
    vals = _edge(m) + [RNG.randrange(m) for _ in range(3)]
    x = _plane(vals)
    fn = getattr(ring, method)
    for e in _exponents(m):
        got = lb.limbs_to_int_batch(fn(x, e))
        assert got == [pow(v, e, m) for v in vals], (method, e)
    for e in (0, -1):
        with pytest.raises(ValueError, match="e must be >= 1"):
            fn(x, e)


@pytest.mark.parametrize("ring_id", sorted(RINGS))
def test_the_chain_takes_the_reduced_exponent(ring_id, monkeypatch):
    """An e in [1, m - 1] reaches the chain wrapper unchanged (the paths'
    exponents: one call); a larger one as e' = ((e - 1) mod (m - 1)) + 1,
    split into parts whose sum is e' where its chain is too long."""
    ring, m = RINGS[ring_id]
    seen = []

    def record(a, e, modulus):          # the values are checked above
        seen.append(e)
        return a

    monkeypatch.setattr(K, "mod_pow_chain_plain", record)
    x = _plane([3, m - 1])
    path = [m - 2] + ([(m - 3) // 4] if m == gold.P else [])
    for e in path + [1, 2, m - 1]:
        seen.clear()
        ring.pow_const_chain(x, e)
        assert seen == [e], e
    for e in _exponents(m):
        reduced = (e - 1) % (m - 1) + 1
        seen.clear()
        ring.pow_const(x, e)
        assert seen == ring._exponent_parts(e) == \
            modring._chain_parts(reduced) and sum(seen) == reduced, e
    assert modring._chain_parts(2**255 + 1) == [2**255 + 1]
    assert len(modring._chain_parts(m - 1)) == 1


def test_aliases_match_the_jax_modules():
    rng = np.random.default_rng(12)
    m_edges = [0, 1, gold.N - 1, gold.N, gold.N + 1, gold.P - 1, gold.P,
               2**256 - 1]
    rows = np.stack([np.frombuffer(v.to_bytes(32, "big"), np.uint8)
                     for v in m_edges], axis=-1)
    for port, jax_mod in ((fe, jfe), (sc, jsc)):
        got = port.bytes_are_canonical(torch.as_tensor(rows)).tolist()
        assert got == np.asarray(jax_mod.bytes_are_canonical(rows)).tolist()
    wide = rng.integers(0, 256, (48, 8)).astype(np.uint8)
    wide[:, 0] = 255
    wide[:, 1] = 0
    got = lb.limbs_to_int_batch(sc.from_wide_bytes(torch.as_tensor(wide)))
    want = jlb.limbs_to_int_batch(np.asarray(jsc.from_wide_bytes(wide)))
    assert got == want == [int.from_bytes(wide[:, i].tobytes(), "big")
                           % gold.N for i in range(8)]
    x = _plane(_edge(gold.P))
    assert torch.equal(fe.pow_const(x, 65537), fe.F.pow_const(x, 65537))
