"""The port's sharded paths against the JAX package's on its 8-device CPU
mesh (`slow`: each JAX pipeline compiles for minutes on XLA:CPU).

- Sharded MSM: JAX `sharded.sharded_msm` over 8 devices against the port's
  8 virtual shards (`local_fn` on each slice, the window sums stacked as
  the all-gather stacks them, `_tree_reduce`, `combine_windows`): the
  projective X, Y, Z bit-exact, which holds only if the tree pairs the
  shards in the JAX order.
- Sharded verify: JAX `sharded.sharded_verify_fn` over 8 devices against
  the port's on a world of one rank (gloo), every lane's status equal, on
  valid lanes and lanes corrupted four ways.

Tolerance 0.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gold
from secp256k1_tpu.ops import limbs as jlb
from secp256k1_tpu.ops import point as jpt
from secp256k1_tpu.parallel import mesh as jmesh
from secp256k1_tpu.parallel import sharded as jsharded
from secp256k1_tpu_torch import entry
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import msm
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.parallel import mesh as meshmod
from secp256k1_tpu_torch.parallel import sharded

torch.set_num_threads(1)

pytestmark = pytest.mark.slow

RNG = random.Random(9090)
N_DEV = 8


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=lb.DTYPE)


def test_sharded_msm_matches_jax_bit_exact():
    n, w = 32, 4
    ks = [RNG.randrange(gold.N) for _ in range(n)]
    pts = [gold.affine_mul(RNG.randrange(1, gold.N), gold.GEN)
           for _ in range(n)]
    want = jsharded.sharded_msm(jmesh.data_mesh(N_DEV),
                                np.asarray(jlb.int_to_limbs_batch(ks)),
                                jpt.from_affine_ints(pts), window_bits=w)
    scalars, points = _plane(ks), pt.from_affine_ints(pts, device="cpu")
    local_fn, _ = sharded.sharded_msm_split(None, w)
    step = n // N_DEV
    with torch.inference_mode():
        wsums = torch.stack([
            local_fn(scalars[:, i:i + step],
                     pt.Point(*(c[:, i:i + step] for c in points)))
            for i in range(0, n, step)])
        got = msm.combine_windows(sharded._tree_reduce(wsums), w)
    for g, j in zip(got, want):
        assert g.reshape(16).tolist() == np.asarray(j).reshape(16).tolist()


def test_sharded_verify_statuses_match_jax(tmp_path):
    b = 2 * N_DEV
    rows = []
    for i in range(b):
        d = RNG.randrange(1, gold.N)
        digest = hashlib.sha256(bytes([i])).digest()
        e, r, s = entry._host_sign_rfc6979(d, digest)
        q = gold.affine_mul(d, gold.GEN)
        if i % 5 == 1:
            r = (r + 1) % gold.N                 # wrong r
        elif i % 5 == 2:
            s = 0                                # invalid signature
        elif i % 5 == 3:
            q = gold.affine_mul(d + 1, gold.GEN)  # another key
        elif i % 5 == 4:
            e ^= 1                               # another digest
        rows.append((q[0], q[1], e, r, s))
    cols = list(zip(*rows))
    jmesh_ = jmesh.data_mesh(N_DEV)
    jargs = jmesh.shard_batch(jmesh_, tuple(
        jnp.asarray(jlb.int_to_limbs_batch(list(c))) for c in cols))
    want = np.asarray(jsharded.sharded_verify_fn(jmesh_)(*jargs)).tolist()
    assert want.count(0) == 4 and len(set(want)) > 2

    meshmod.init_distributed(device="cpu",
                             init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        mesh = meshmod.data_mesh()
        shards = meshmod.shard_batch(mesh, tuple(_plane(list(c))
                                                 for c in cols))
        with torch.inference_mode():
            got = meshmod.gather_batch(
                mesh, sharded.sharded_verify_fn(mesh)(*shards))
    finally:
        dist.destroy_process_group()
    assert got.tolist() == want
