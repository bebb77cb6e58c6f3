"""The packed G tables the fixed-base kernels read, on the CPU.

`table.pack_words` (int32 [W, E, 16], `base_windowed_add_final`'s gather)
and `table.pack_bytes` (uint8 [W, 64, E_pad], the B operand of
`base_windowed_add`'s int8 tensor-core select) must round-trip to the int32
[W, E, 2, 16] table, and the kernel's select, a one-hot [lanes, E_pad]
times the window's bytes [E_pad, 64] with one nonzero term an output, is
modelled here as an int32 matmul and must reproduce
`table.lookup_shared_affine`.  Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from secp256k1_tpu_torch.ops import table as tbl

torch.set_num_threads(1)

# (window bits, signed): the kernels' widths.
WIDTHS = [(6, True), (8, True), (12, True), (8, False)]


def _ids(widths):
    return [f"{'signed' if s else 'unsigned'}-w{w}" for w, s in widths]


@pytest.mark.parametrize("bits,signed", WIDTHS, ids=_ids(WIDTHS))
def test_packed_tables_round_trip(bits, signed):
    table = tbl.base_table("cpu", bits, signed)
    n_windows, n_entries = table.shape[:2]
    words = tbl.base_table_words("cpu", bits, signed)
    by = tbl.base_table_bytes("cpu", bits, signed)
    e_pad = -(-n_entries // 32) * 32
    assert words.dtype == torch.int32 and words.is_contiguous()
    assert words.shape == (n_windows, n_entries, 16)
    assert by.dtype == torch.uint8 and by.is_contiguous()
    assert by.shape == (n_windows, 64, e_pad)
    # Cached with the table's key; packed_of finds the cached copy.
    assert tbl.base_table_words("cpu", bits, signed) is words
    assert tbl.packed_of(table, "bytes") is by
    assert tbl.packed_of(table, "words") is words

    limbs = table.numpy().astype(np.int64).reshape(n_windows, n_entries, 32)
    w64 = words.numpy().astype(np.int64) & 0xFFFFFFFF
    assert np.array_equal(w64 & 0xFFFF, limbs[..., 0::2])
    assert np.array_equal(w64 >> 16, limbs[..., 1::2])
    b = by.numpy().astype(np.int64)[:, :, :n_entries]
    assert np.array_equal(b[:, 0::2] | (b[:, 1::2] << 8),
                          limbs.transpose(0, 2, 1))
    b = by.numpy()
    assert not b[:, :, n_entries:].any()          # the zero pad entries
    if not signed:
        assert (n_entries, e_pad) == (255, 256)
    # A table that is not a cached one is packed on the spot.
    copy = table[:2].clone()
    assert torch.equal(tbl.packed_of(copy, "bytes"), by[:2])
    assert torch.equal(tbl.packed_of(copy, "words"), words[:2])


def _select_bytes(by_w, digits, signed):
    """The kernel's select on one window, modelled: one-hot rows
    (e + 1 == magnitude) times the window's bytes, an int32 matmul, the
    64 bytes of each row joined into (x, y) limb planes [16, B]."""
    mags = digits & 0xFFFF if signed else digits
    e_pad = by_w.shape[1]
    ids = torch.arange(1, e_pad + 1, dtype=torch.int32)
    onehot = (mags.unsqueeze(1) == ids.unsqueeze(0)).to(torch.int32)
    prod = onehot @ by_w.to(torch.int32).t()              # [B, 64]
    assert int(prod.max()) <= 255                         # one term each
    limbs = (prod[:, 0::2] | (prod[:, 1::2] << 8)).t()    # [32, B]
    return limbs[:16], limbs[16:]


@pytest.mark.parametrize("bits,signed", WIDTHS, ids=_ids(WIDTHS))
def test_onehot_byte_product_matches_lookup_shared_affine(bits, signed):
    """Every magnitude 0..E of one window (E = 32, 128, 2,048 and 255
    padded to 256), with and without the sign bit where signed."""
    table = tbl.base_table("cpu", bits, signed)
    by = tbl.base_table_bytes("cpu", bits, signed)
    n_entries = table.shape[1]
    w = table.shape[0] // 2
    mags = torch.arange(n_entries + 1, dtype=torch.int32)
    digits = mags | ((mags & 1) << 16) if signed else mags
    for lo in range(0, mags.numel(), 512):
        d = digits[lo:lo + 512]
        got = _select_bytes(by[w], d, signed)
        want = tbl.lookup_shared_affine(table[w], mags[lo:lo + 512])
        assert all(torch.equal(g, v) for g, v in zip(got, want))
        # And the entry itself: table[w][m - 1], zeros for m = 0.
        m = mags[lo:lo + 512].long()
        ent = table[w][(m - 1).clamp(min=0)] * (m > 0).view(-1, 1, 1)
        assert torch.equal(got[0], ent[:, 0].t())
        assert torch.equal(got[1], ent[:, 1].t())


@pytest.mark.parametrize("bits", [6, 8, 12])
def test_sign_bit_alone_selects_zero(bits):
    """Magnitude 0 with the sign bit set gives an all-zero one-hot row:
    (x, y) = (0, 0), as `lookup_shared_affine` gives."""
    by = tbl.base_table_bytes("cpu", bits, True)
    digits = torch.tensor([1 << 16, 0, (1 << 16) | 1], dtype=torch.int32)
    x, y = _select_bytes(by[1], digits, signed=True)
    assert not x[:, :2].any() and not y[:, :2].any()
    table = tbl.base_table("cpu", bits, True)
    assert torch.equal(x[:, 2], table[1, 0, 0])
    assert torch.equal(y[:, 2], table[1, 0, 1])
