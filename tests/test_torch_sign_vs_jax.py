"""The signing slice against the JAX package's device cores on the same 16
lanes: `_sign_e2e_core` (the port's `_sign_from_candidates`, which
takes the same candidates; its `_sign_e2e_core` derives them first),
`_recover_core`, `_verify_keyed_core`, the three
Schnorr sign stages and `_schnorr_verify_e2e_core`, every output (bytes,
flags, statuses) exact.

Marked `slow`: each jitted JAX core takes minutes to compile on XLA:CPU, so
tier-1 (`-m 'not slow'`) leaves it out.  Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sign_vs_jax.py -m slow
"""

import hashlib

import numpy as np
import pytest
import torch

from secp256k1_tpu.models import ecdsa as jecdsa
from secp256k1_tpu.models import schnorr as jschnorr
from secp256k1_tpu.utils import batching as jbt
from secp256k1_tpu_torch.models import ecdsa, schnorr
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.utils import batching as bt
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

N, P = hc.N, hc.P
LANES = 16
CPU = "cpu"
pytestmark = pytest.mark.slow


def _rows(vals):
    return np.stack([np.frombuffer(int(v).to_bytes(32, "big"), np.uint8)
                     for v in vals])


def _both(rows):
    """The same [16, W] u8 rows as a JAX and a port byte plane."""
    return jbt.byte_plane_np(rows, LANES), bt.byte_plane_np(rows, LANES, CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _assert_same(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        assert np.array_equal(_np(j).reshape(-1), _np(p).reshape(-1))


@pytest.fixture(scope="module")
def lanes():
    """16 signing lanes: valid keys and nonces, a candidate of 0 and of n,
    a key of 0."""
    rng = np.random.default_rng(2002)

    def rand():
        return int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    d = [rand() for _ in range(LANES)]
    k = [rand() for _ in range(LANES)]
    e = [int.from_bytes(hashlib.sha256(b"%d" % i).digest(), "big")
         for i in range(LANES)]
    k[1], k[2], d[3] = 0, N, 0
    return d, k, e


def test_sign_e2e_core_matches_jax(lanes):
    d, k, e = lanes
    (jk, pk), (je, pe), (jd, pd) = _both(_rows(k)), _both(_rows(e)), \
        _both(_rows(d))
    _assert_same(jecdsa._sign_e2e_core(jk, je, jd),
                 ecdsa._sign_from_candidates(pk, pe, pd))


def test_recover_core_matches_jax(lanes):
    d, k, e = lanes
    _, pk = _both(_rows(k))
    _, pe = _both(_rows(e))
    _, pd = _both(_rows(d))
    r_b, s_b, recid, _, _ = ecdsa._sign_from_candidates(pk, pe, pd)
    r_rows = r_b.T.numpy().astype(np.uint8)
    s_rows = s_b.T.numpy().astype(np.uint8)
    recid = recid.numpy().astype(np.int32)
    recid[4] ^= 1                                   # wrong parity
    recid[5] = 6                                    # not a recovery id
    jr, pr = _both(r_rows)
    e_ints = [v % N for v in e]
    r_ints = [int.from_bytes(r.tobytes(), "big") for r in r_rows]
    s_ints = [int.from_bytes(s.tobytes(), "big") for s in s_rows]
    planes = [lb.int_to_limbs_batch(v) for v in (e_ints, r_ints, s_ints)]
    jax_out = jecdsa._recover_core(
        jr, jbt.scalar_plane(recid, LANES),
        *[jbt.plane(v, LANES) for v in (e_ints, r_ints, s_ints)])
    port_out = ecdsa._recover_core(
        pr, torch.as_tensor(recid),
        *[torch.as_tensor(p, dtype=torch.int32) for p in planes])
    _assert_same(jax_out, port_out)


def test_verify_keyed_core_matches_jax(lanes):
    d, k, e = lanes
    _, pk = _both(_rows(k))
    _, pe = _both(_rows(e))
    _, pd = _both(_rows(d))
    r_b, s_b, _, _, _ = ecdsa._sign_from_candidates(pk, pe, pd)
    r_rows = r_b.T.numpy().astype(np.uint8)
    s_rows = s_b.T.numpy().astype(np.uint8)
    s_rows[6] = _rows([N - int.from_bytes(s_rows[6].tobytes(), "big")])[0]
    pubs = [hc.mul(v, hc.G) or hc.G for v in d]
    idx = np.arange(LANES, dtype=np.int32)
    idx[7] = 8                                      # another key
    host = np.zeros((LANES,), np.int32)
    host[9] = 4
    qx = lb.int_to_limbs_batch([p[0] for p in pubs])
    qy = lb.int_to_limbs_batch([p[1] for p in pubs])
    je, pe = _both(_rows(e))
    jr, pr = _both(r_rows)
    js, ps = _both(s_rows)
    jax_st = jecdsa._verify_keyed_core(
        jbt.plane([p[0] for p in pubs], LANES),
        jbt.plane([p[1] for p in pubs], LANES),
        jbt.scalar_plane(idx, LANES), je, jr, js, True,
        jbt.scalar_plane(host, LANES))
    port_st = ecdsa._verify_keyed_core(
        torch.as_tensor(qx, dtype=torch.int32),
        torch.as_tensor(qy, dtype=torch.int32), torch.as_tensor(idx), pe,
        pr, ps, True, torch.as_tensor(host))
    _assert_same([jax_st], [port_st])


def test_schnorr_stages_and_verify_match_jax(lanes):
    d, k, _ = lanes
    jd, pd = _both(_rows(d))
    j1, p1 = jschnorr._schnorr_sign_stage1(jd), \
        schnorr._schnorr_sign_stage1(pd)
    _assert_same(j1, p1)
    jk, pk = _both(_rows(k))
    j2, p2 = jschnorr._schnorr_sign_stage2(jk), \
        schnorr._schnorr_sign_stage2(pk)
    _assert_same(j2, p2)
    rng = np.random.default_rng(3003)
    e_rows = rng.integers(0, 256, (LANES, 32), dtype=np.uint8)
    e_rows[:, 0] &= 0x7F                            # e < n
    je, pe = _both(e_rows)
    j3 = jschnorr._schnorr_sign_stage3(jk, j2[1], j1[1], je, j2[0])
    p3 = schnorr._schnorr_sign_stage3(pk, p2[1], p1[1], pe, p2[0])
    _assert_same(j3, p3)

    # Verify what stage 3 signed, with the challenge it was given, plus a
    # flipped signature byte, an s >= n and an r >= p.
    pub_x = p1[0].T.numpy().astype(np.uint8)
    r_rows = p2[0].T.numpy().astype(np.uint8)
    s_rows = p3[0].T.numpy().astype(np.uint8)
    r_rows[10, 31] ^= 1
    s_rows[11] = _rows([N])[0]
    r_rows[12] = _rows([P])[0]
    args = [_both(a) for a in (pub_x, r_rows, s_rows, e_rows)]
    jv = jschnorr._schnorr_verify_e2e_core(*[a[0] for a in args])
    pv = schnorr._schnorr_verify_e2e_core(*[a[1] for a in args])
    _assert_same([jv], [pv])
