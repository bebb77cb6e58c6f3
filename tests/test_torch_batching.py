"""The port's batch marshalling against the JAX package's flat CPU layout.

On the CPU the JAX package keeps planes flat ([16, B], no [16, S, 128]
tiling and no 1024-lane padding), which is the port's only layout, so the
two must produce the same arrays.  `batch_shape` and `Point.batch_shape`
agree with the JAX ones while JAX's Pallas switch is off; with it on, JAX
tiles and the port stays flat (a deliberate difference).
"""

import numpy as np
import pytest
import torch

from secp256k1_tpu.ops import pallas as jpallas
from secp256k1_tpu.ops import point as jpt
from secp256k1_tpu.utils import batching as jbt
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.utils import batching as bt

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1 << 16])
def test_bucket_and_auto_chunk_match_jax(n):
    assert bt.bucket(n) == jbt.bucket(n)
    assert bt.auto_chunk(n, None) == jbt.auto_chunk(n, None)
    assert bt.auto_chunk(n, 64) == 64
    assert bt.auto_chunk((1 << 20) + 1, None) == 1 << 20
    with pytest.raises(ValueError):
        bt.bucket((1 << 20) + 1)


def test_planes_match_jax_and_round_trip():
    rng = np.random.default_rng(5)
    ints = [int.from_bytes(rng.bytes(32), "big") for _ in range(20)]
    got = bt.plane(ints, 32, fill=7, device=CPU)
    want = np.asarray(jbt.plane(ints, 32, fill=7))
    assert got.dtype == torch.int32 and got.shape == (16, 32)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert bt.unplane_ints(got, 20) == ints
    assert bt.unplane_ints(got, 21)[20] == 7

    rows = rng.integers(0, 256, size=(20, 33), dtype=np.uint8)
    got = bt.byte_plane_np(rows, 32, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == (33, 32)
    assert np.array_equal(got.numpy(), np.asarray(jbt.byte_plane_np(rows, 32)))
    assert bt.unplane_bytes(got, 20) == [r.tobytes() for r in rows]
    assert bt.unplane_bytes(got, 32)[31] == rows[-1].tobytes()

    flags = rng.integers(0, 12, size=20).astype(np.int32)
    got = bt.scalar_plane(flags, 32, fill=3, device=CPU)
    want = np.asarray(jbt.scalar_plane(flags, 32, fill=3))
    assert np.array_equal(got.numpy(), want)
    assert bt.unplane_flags(got, 20) == flags.tolist()
    mask = bt.scalar_plane(flags > 5, 32, fill=False, dtype=torch.bool,
                           device=CPU)
    assert mask.dtype == torch.bool and not bool(mask[20:].any())


@pytest.mark.parametrize("pallas_on", [False, True], ids=["flat", "tiled"])
def test_batch_shape_is_flat(pallas_on):
    was = jpallas._ENABLED
    jpallas.set_enabled(pallas_on)
    try:
        for b in (1024, 2048, 1 << 16):
            assert bt.batch_shape(b) == (b,)
            want = (b // 128, 128) if pallas_on else (b,)
            assert jbt.batch_shape(b) == want
        if not pallas_on:
            for b in (1, 16, 1000):
                assert bt.batch_shape(b) == jbt.batch_shape(b)
    finally:
        jpallas.set_enabled(was)


def test_point_batch_shape_matches_jax():
    for b in (1, 5, 64):
        planes = [np.zeros((16, b), np.uint32)] * 3
        port = pt.Point(*[torch.as_tensor(c.astype(np.int32)) for c in planes])
        assert port.batch_shape == jpt.Point(*planes).batch_shape == (b,)
    assert pt.generator((3,), CPU).batch_shape == (3,)
