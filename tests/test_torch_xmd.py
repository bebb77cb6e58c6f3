"""RFC 9380 expand_message_xmd on the card: `kernels.expand_xmd`.

Marked `card` and skipped without one (the kernel has no CPU form; its
lane body is held to the JAX package's expansion with g++ in
`tests/test_torch_csrc_host.py`, its plain version in
`tests/test_torch_h2c_lens.py`).  On a card: the kernel against its plain
version (the native SHA-256 on the host) on the `h2c.ro` mix of lengths at
65,536 lanes and at a ragged count, on every length 0-600 under three
DSTs, and the arrays entry points on the card against their CPU path with
the counts of one call.  Nothing here imports JAX, so the card's machine
runs it: `python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_xmd.py`.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.models import h2c
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt

DST = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"
# A 255-byte DST (the longest hashed as it is) and an oversize one, which
# the host reduces to 32 bytes.
DSTS = {"dst49": DST, "dst255": bytes(range(1, 256)), "dst300": b"x" * 300}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mix(n, seed):
    """`h2c.ro`'s lengths: 0-128 evenly, 1 in 64 of 517 bytes, in rows 517
    wide whose bytes past each length are not zero."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 129, n).astype(np.int32)
    lens[rng.choice(n, max(1, n // 64), replace=False)] = 517
    return rng.integers(1, 256, (n, 517), dtype=np.uint8), lens


def _dst_prime(dst, n_out):
    dst, _ = h2c._dst_and_ell(dst, n_out)
    return dst + bytes([len(dst)])


def _both(rows, lens, dst_prime, n_out, lanes, device):
    args = (torch.from_numpy(rows).to(device),
            torch.from_numpy(lens).to(device))
    launches = K.LAUNCHES["expand_xmd"]
    got = K.expand_xmd(*args, dst_prime, n_out, lanes)
    torch.cuda.synchronize()
    assert K.LAUNCHES["expand_xmd"] == launches + 1
    want = K.expand_xmd_plain(*args, dst_prime, n_out, lanes)
    return got, want


@pytest.mark.card
@pytest.mark.parametrize("n", [65536, 65531])
@pytest.mark.parametrize("n_out", [48, 96])
def test_card_expand_xmd_equals_plain_on_the_mix(card, n, n_out):
    """One launch at the cell's width (and at 5 messages fewer, the last
    lanes padded): every lane equal to the host expansion's planes."""
    rows, lens = _mix(n, n + n_out)
    got, want = _both(rows, lens, _dst_prime(DST, n_out), n_out,
                      bt.bucket(n), card)
    assert got.shape == want.shape == (48, n_out // 48 * 65536)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("dst", sorted(DSTS))
def test_card_expand_xmd_equals_plain_at_every_length(card, dst):
    """Every length 0-600 in rows 640 wide, 4 messages a length, under
    the suite's DST, a 255-byte one and an oversize one."""
    rng = np.random.default_rng(len(DSTS[dst]))
    lens = np.repeat(np.arange(601, dtype=np.int32), 4)
    rows = rng.integers(1, 256, (lens.size, 640), dtype=np.uint8)
    got, want = _both(rows, lens, _dst_prime(DSTS[dst], 96), 96,
                      bt.bucket(lens.size), card)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_card_arrays_equal_the_cpu_path(card, suite):
    """The arrays entry point on the card and on the CPU: the same points
    and flags for 300 messages of the mix; one expansion launch, its
    shape (lanes, row width), and the messages in XMD_LANES["device"]."""
    arrays = h2c.hash_to_curve_batch_arrays if suite == "RO" \
        else h2c.encode_to_curve_batch_arrays
    rows, lens = _mix(300, 7)
    before, launches = dict(h2c.XMD_LANES), K.LAUNCHES["expand_xmd"]
    shapes = K.SHAPES.get(("expand_xmd", 512, 517), 0)
    pts, ident = arrays(rows, DST, lens)
    assert K.LAUNCHES["expand_xmd"] == launches + 1
    assert K.SHAPES[("expand_xmd", 512, 517)] == shapes + 1
    assert h2c.XMD_LANES["device"] == before["device"] + 300
    want = arrays(rows, DST, lens, device="cpu")
    assert np.array_equal(pts, want[0]) and np.array_equal(ident, want[1])
