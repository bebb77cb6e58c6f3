"""The port's sharding on `torch.distributed` (`parallel/`), on the CPU.

- `dryrun_multichip(2)`: two gloo ranks, each a process, run sharded verify
  and the sharded MSM (`secp256k1_tpu_torch.entry`).
- Virtual shards: the MSM's points cut into D slices, each slice's window
  sums by `local_fn`, stacked, reduced by `_tree_reduce` and folded by
  `combine_windows`, equal the unsharded `multi_scalar_mult` and python
  ints (`tests/gold.py`) for D = 1, 2, 3, 4, 8, as an all-gather over D
  ranks would give them.
- In this process, a world of one rank (gloo, a file store): the split
  form composed equals `sharded_msm`, and `shard_batch` and
  `gather_batch` round-trip; a stand-in mesh of three ranks checks the
  slicing of a rank past the first.
- `init_distributed` passes its arguments through; `data_mesh` raises
  without a process group and for another size than the world's.

Tolerance 0 throughout: results are bit-exact or status-exact.
"""

import random

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gold
from secp256k1_tpu_torch import entry
from secp256k1_tpu_torch.ops import limbs as lb
from secp256k1_tpu_torch.ops import msm
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.parallel import mesh as meshmod
from secp256k1_tpu_torch.parallel import sharded

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

RNG = random.Random(4243)
N_POINTS = 24                    # splits over 1, 2, 3, 4 and 8 shards
WINDOW_BITS = 4                  # under 2,048 points: the sort + scan path


def _plane(vals):
    return torch.as_tensor(lb.int_to_limbs_batch(vals), dtype=lb.DTYPE)


def _affine(p):
    zi = gold.inv_mod(lb.limbs_to_int(p.z.reshape(16)), gold.P)
    return tuple(lb.limbs_to_int(c.reshape(16)) * zi % gold.P
                 for c in (p.x, p.y))


@pytest.fixture(scope="module")
def msm_case():
    """(scalars, points, python-int sum, unsharded multi_scalar_mult)."""
    # Points a_i G with a_i = a + i, so the sum is (sum_i k_i a_i) G.
    ks = [RNG.randrange(gold.N) for _ in range(N_POINTS)]
    a = RNG.randrange(1, gold.N - N_POINTS)
    pts = [gold.affine_mul(a, gold.GEN)]
    while len(pts) < N_POINTS:
        pts.append(gold.affine_add(pts[-1], gold.GEN))
    want = gold.affine_mul(sum(k * (a + i) for i, k in enumerate(ks))
                           % gold.N, gold.GEN)
    scalars, points = _plane(ks), pt.from_affine_ints(pts, device="cpu")
    with torch.inference_mode():
        whole = msm.multi_scalar_mult(scalars, points, WINDOW_BITS)
    return scalars, points, want, whole


@pytest.fixture
def world_of_one(tmp_path):
    """A process group of this process alone (gloo) and its mesh."""
    meshmod.init_distributed(device="cpu",
                             init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        yield meshmod.data_mesh(1)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_two_ranks(capsys):
    entry.dryrun_multichip(2)
    assert "dryrun_multichip(2): verify + sharded MSM OK" in \
        capsys.readouterr().out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_virtual_shards_equal_the_unsharded_msm(msm_case, n_shards):
    scalars, points, want, whole = msm_case
    local_fn, _ = sharded.sharded_msm_split(None, WINDOW_BITS)
    step = N_POINTS // n_shards
    with torch.inference_mode():
        wsums = torch.stack([
            local_fn(scalars[:, i:i + step],
                     pt.Point(*(c[:, i:i + step] for c in points)))
            for i in range(0, N_POINTS, step)])
        assert wsums.shape == (n_shards, 256 // WINDOW_BITS, 3, 16)
        got = msm.combine_windows(sharded._tree_reduce(wsums), WINDOW_BITS)
    assert _affine(got) == _affine(whole) == want


def test_tree_reduce_keeps_the_pairing_order():
    """The JAX order: shards (a, b, c) give (a + b) + c, the odd one carried
    a level; shards (a, b, c, d) give (a + c) + (b + d), the first half
    plus the second.  The projective results of exactly those adds."""
    rows = torch.stack([msm._point_to_rows(pt.from_affine_ints(
        [gold.affine_mul(RNG.randrange(1, gold.N), gold.GEN)
         for _ in range(2)], device="cpu")) for _ in range(4)])
    add = msm._rows_add
    with torch.inference_mode():
        assert torch.equal(sharded._tree_reduce(rows[:3]),
                           add(add(rows[0], rows[1]), rows[2]))
        assert torch.equal(sharded._tree_reduce(rows),
                           add(add(rows[0], rows[2]), add(rows[1], rows[3])))
        assert not torch.equal(sharded._tree_reduce(rows),
                               add(add(rows[0], rows[1]),
                                   add(rows[2], rows[3])))


def test_split_composed_equals_sharded_msm(world_of_one, msm_case):
    mesh = world_of_one
    scalars, points, want, whole = msm_case
    local_fn, combine_fn = sharded.sharded_msm_split(mesh, WINDOW_BITS)
    with torch.inference_mode():
        fused = sharded.sharded_msm(mesh, *meshmod.shard_batch(
            mesh, (scalars, points)), window_bits=WINDOW_BITS)
        split = combine_fn(local_fn(scalars, points))
    for a, b, c in zip(fused, split, whole):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert _affine(fused) == want


def test_shard_and_gather_round_trip(world_of_one):
    mesh = world_of_one
    plane = _plane([RNG.randrange(gold.P) for _ in range(6)])
    p = pt.from_affine_ints([gold.GEN] * 6, device="cpu")
    status = torch.arange(6, dtype=torch.int32)
    shards = meshmod.shard_batch(mesh, (plane, p, status,
                                        plane.numpy().astype(np.int32)))
    back = meshmod.gather_batch(mesh, shards)
    assert isinstance(back[1], pt.Point)
    for got, want in zip((back[0], *back[1], back[2], back[3]),
                         (plane, *p, status, plane)):
        assert torch.equal(got, want)
    meshmod.barrier("round trip", timeout_s=30)


class _ThreeRanks:
    """A stand-in mesh: rank 1 of 3 on the CPU."""
    device_type = "cpu"

    def size(self):
        return 3

    def get_local_rank(self, dim):
        assert dim == "data"
        return 1


def test_shard_batch_takes_the_ranks_slice():
    x = torch.arange(2 * 9, dtype=torch.int32).reshape(2, 9)
    assert torch.equal(meshmod.shard_batch(_ThreeRanks(), x), x[:, 3:6])
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        meshmod.shard_batch(_ThreeRanks(), x[:, :8])


def test_init_distributed_forwards_args(monkeypatch):
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    meshmod.init_distributed(device="cpu", init_method="tcp://10.0.0.1:1234",
                             world_size=4, rank=2)
    assert seen == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                    "world_size": 4, "rank": 2}
    seen.clear()
    meshmod.init_distributed(device="cpu", backend="nccl", world_size=1,
                             rank=0)
    assert seen == {"backend": "nccl", "world_size": 1, "rank": 0}


def test_data_mesh_raises_without_a_group_or_at_another_size(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        meshmod.data_mesh()
    meshmod.barrier("no group")                    # a no-op, as in JAX
    meshmod.init_distributed(device="cpu",
                             init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="world has 1 ranks"):
            meshmod.data_mesh(2)
        mesh = meshmod.data_mesh()
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
