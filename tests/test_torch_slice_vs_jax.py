"""The verify slice against JAX `_verify_impl` on the same 16 lanes.

Marked `slow`: the jitted JAX `_verify_impl` takes about three minutes to
compile on XLA:CPU, so tier-1 (`-m 'not slow'`) leaves it out.  Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_slice_vs_jax.py -m slow
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_tpu.models import ecdsa as jecdsa
from secp256k1_tpu_torch import convert
from secp256k1_tpu_torch.models import ecdsa
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.utils import errors as ec
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

N = hc.N


def _lanes():
    """16 (qx, qy, e, r, s) lanes and their statuses: valid signatures,
    a wrong digest, r = 0, s = 0, a wrong key, and x_R >= n (r + n < p)."""
    rng = np.random.default_rng(16)
    rows, want = [], []
    for i in range(12):
        d = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        k = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        e = int.from_bytes(hashlib.sha256(b"%d" % i).digest(), "big") % N
        r = hc.mul(k, hc.G)[0] % N
        s = pow(k, N - 2, N) * (e + r * d) % N
        q = hc.mul(d, hc.G)
        rows.append([q[0], q[1], e, r, s])
        want.append(ec.OK)
    rows[1][2] ^= 1
    want[1] = ec.ERR_V_NEQ_R
    rows[2][3] = 0
    want[2] = ec.ERR_INVALID_SIGNATURE
    rows[3][4] = 0
    want[3] = ec.ERR_INVALID_SIGNATURE
    rows[4][:2] = rows[5][:2]
    want[4] = ec.ERR_V_NEQ_R
    x = N
    while hc.lift_x(x, False) is None or x == N:
        x += 1
    big_r = hc.lift_x(x, False)
    r, e, s = x - N, 12345, 67890
    r_inv = pow(r, N - 2, N)
    q = hc.add(hc.mul(s * r_inv % N, big_r), hc.neg(hc.mul(e * r_inv % N,
                                                           hc.G)))
    for i, ee in enumerate((e, e + 1, e, e)):
        rows.append([q[0], q[1], ee, r, s])
        want.append(ec.OK if i != 1 else ec.ERR_V_NEQ_R)
    return rows, want


@pytest.mark.slow
def test_verify_impl_matches_jax():
    rows, want = _lanes()
    planes = [lb.int_to_limbs_batch([row[j] for row in rows]).astype(
        np.uint32) for j in range(5)]
    jax_st = np.asarray(jax.jit(jecdsa._verify_impl)(
        *[jnp.asarray(p) for p in planes]))
    port_st = ecdsa._verify_impl(*[convert.plane_to_torch(p)
                                   for p in planes])
    assert port_st.tolist() == want
    assert jax_st.astype(np.int64).tolist() == want
