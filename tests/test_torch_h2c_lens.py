"""The port's hash-to-curve over messages of varying length, on the CPU.

Messages of mixed lengths go in as zero-padded rows [n, L] with their
lengths [n]:

- `native.sha256_batch` with lengths and a suffix against `hashlib` at
  every length 0-200 and 517 (SHA-256's padding boundaries 55/56, 63/64,
  119/120 among them), with the bytes past each length not zero, and its
  count of compressions;
- `expand_message_xmd_batch(..., lens)` against the JAX package's
  one-message `expand_message_xmd`, and `lens=None` as before;
- `hash_to_curve_batch_arrays` and `encode_to_curve_batch_arrays` with
  lengths against the RFC 9380 J.8.1 (J.8.2) vectors and, on every lane,
  the python-int oracle of `h2c_oracle.py` over the JAX package's
  expansion;
- the ValueErrors on a bad `lens`;
- `h2c.XMD_HOST_BLOCKS` against SHA-256's padding rule;
- the expansion kernel's wrapper `kernels.expand_xmd` on the CPU (its
  plain version): the [48, 2B] and [48, B] planes of
  `expand_message_xmd_batch` and `byte_plane_np`, padded lanes included;
  the cores `_ro_bytes_core` and `_nu_bytes_core` from rows, lengths and
  DST' against the J.8.1 (J.8.2) vectors; the counts `h2c.XMD_LANES` and
  `PLAIN_CALLS["expand_xmd"]`; the wrapper's ValueErrors.

Every comparison is exact.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import h2c_oracle as oracle
from secp256k1_tpu.models import h2c as jh2c
from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import h2c
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

CPU = "cpu"
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
SUITES = {"RO": ("secp256k1_XMD_SHA-256_SSWU_RO_.json",
                 h2c.hash_to_curve_batch_arrays),
          "NU": ("secp256k1_XMD_SHA-256_SSWU_NU_.json",
                 h2c.encode_to_curve_batch_arrays)}
DST = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"


@pytest.fixture(autouse=True)
def _inference_mode():
    """No autograd bookkeeping: the plain path dispatches many small ops."""
    with torch.inference_mode():
        yield


def _padded(msgs, width=None, fill=0xA5):
    """Rows [n, width] holding each message, the bytes past it `fill`
    (not zero, so a length that is not honoured shows), and the lengths."""
    width = max(len(m) for m in msgs) if width is None else width
    rows = np.full((len(msgs), width), fill, np.uint8)
    for i, m in enumerate(msgs):
        rows[i, :len(m)] = np.frombuffer(m, np.uint8)
    return rows, np.array([len(m) for m in msgs], np.int32)


def _suite(name):
    fname, arrays = SUITES[name]
    with open(os.path.join(TESTDATA, fname)) as f:
        data = json.load(f)
    return data, arrays


def _blocks(nbytes):
    """SHA-256 compressions of a message of nbytes: the padding adds a
    0x80 byte and an 8-byte length, then fills to a 64-byte block."""
    return -(-(nbytes + 9) // 64)


# --- native SHA-256 of rows each at its own length ------------------------

@pytest.mark.parametrize("width", [200, 517, 640])
def test_sha256_var_batch_matches_hashlib(width):
    """Every length 0-200 and 517 that fits the row, in one call, alone,
    followed by a 52-byte suffix (b0's tail under a 49-byte DST), and
    between b0's 64 zero bytes and that suffix."""
    rng = np.random.default_rng(width)
    lens = np.array([n for n in list(range(201)) + [517] if n <= width])
    rows = rng.integers(0, 256, (lens.shape[0], width), dtype=np.uint8)
    suffix = rng.integers(0, 256, 52, dtype=np.uint8).tobytes()
    for head, tail in ((b"", b""), (b"", suffix), (bytes(64), suffix)):
        got = native.sha256_batch(rows, lens, prefix=head, suffix=tail)
        for i, n in enumerate(lens):
            assert got[i].tobytes() == hashlib.sha256(
                head + rows[i, :n].tobytes() + tail).digest(), \
                (n, len(head), len(tail))


def test_sha256_var_batch_at_full_length_is_sha256_batch():
    """Full lengths hash as no lengths do, as hashlib does; the tally
    gains the compressions by the padding rule; an empty batch is
    empty."""
    rows = np.random.default_rng(3).integers(0, 256, (7, 119), np.uint8)
    tally = {"blocks": 5}
    whole = native.sha256_batch(rows, tally=tally)
    assert np.array_equal(native.sha256_batch(rows, np.full(7, 119)), whole)
    assert [r.tobytes() for r in whole] == [
        hashlib.sha256(r.tobytes()).digest() for r in rows]
    assert tally == {"blocks": 5 + 7 * _blocks(119)}
    native.sha256_batch(rows, np.arange(0, 119, 17), suffix=b"s" * 40,
                        tally=tally)
    assert tally["blocks"] == 5 + 7 * _blocks(119) + sum(
        _blocks(n + 40) for n in range(0, 119, 17))
    assert native.sha256_batch(rows[:0], np.zeros(0, np.int32)).shape \
        == (0, 32)


@pytest.mark.parametrize("lens", [np.array([1, 2]), np.array([[1, 2, 3]]),
                                  np.array([1, -1, 3]), np.array([1, 9, 3]),
                                  np.array([1.0, 2.0, 3.0])],
                         ids=["short", "2d", "negative", "past_row", "float"])
def test_sha256_var_batch_rejects_bad_lengths(lens):
    with pytest.raises(ValueError):
        native.sha256_batch(np.zeros((3, 8), np.uint8), lens)


# --- expand_message_xmd over mixed lengths --------------------------------

@pytest.mark.parametrize("n_out", [32, 48, 96, 255])
@pytest.mark.parametrize("dst", [DST, b"x" * 300], ids=["dst49", "dst300"])
def test_expand_batch_with_lengths_matches_one_message(dst, n_out):
    """Lengths 0-140 and 517 in one batch, the bytes past each length not
    zero, against the JAX package's one-message form."""
    rng = np.random.default_rng(n_out)
    lengths = list(range(0, 141, 7)) + [55, 56, 63, 64, 119, 120, 517]
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in lengths]
    rows, lens = _padded(msgs)
    got = h2c.expand_message_xmd_batch(rows, dst, n_out, lens)
    assert got.shape == (len(msgs), n_out)
    for i, m in enumerate(msgs):
        assert got[i].tobytes() == jh2c.expand_message_xmd(m, dst, n_out), \
            len(m)


@pytest.mark.parametrize("width", [0, 24, 65])
def test_expand_batch_without_lengths_is_unchanged(width):
    """lens=None hashes whole rows, as full lengths do, and as the
    JAX package's one-message form hashes them."""
    rows = np.random.default_rng(width).integers(0, 256, (6, width),
                                                 dtype=np.uint8)
    whole = h2c.expand_message_xmd_batch(rows, DST, 96)
    assert np.array_equal(whole, h2c.expand_message_xmd_batch(
        rows, DST, 96, np.full(6, width)))
    for i, r in enumerate(rows):
        assert whole[i].tobytes() == jh2c.expand_message_xmd(r.tobytes(),
                                                             DST, 96)


# --- the arrays entry points over mixed lengths ---------------------------

def _ints(points):
    return [(int.from_bytes(p[:32].tobytes(), "big"),
             int.from_bytes(p[32:].tobytes(), "big")) for p in points]


@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_arrays_with_lengths_give_the_suite_vectors(suite):
    """The five J.8.1 (RO) or J.8.2 (NU) messages, 0 to 517 bytes, as
    padded rows with their lengths, between seeded messages of other
    lengths: the vectors' P on their lanes, the oracle's points on every
    lane."""
    data, arrays = _suite(suite)
    dst = data["dst"].encode()
    rng = np.random.default_rng(21)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (5, 129, 64, 0, 31)]
    at = [1, 3, 4, 6, 8]
    for lane, v in zip(at, data["vectors"]):
        msgs.insert(lane, v["msg"].encode())
    rows, lens = _padded(msgs)
    pts, ident = arrays(rows, dst, lens, device=CPU)
    assert pts.shape == (len(msgs), 64) and not ident.any()
    got = _ints(pts)
    for lane, v in zip(at, data["vectors"]):
        assert got[lane] == (int(v["P"]["x"], 16), int(v["P"]["y"], 16))
    assert got == [oracle.point(m, dst, suite == "RO") for m in msgs]


@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_arrays_without_lengths_are_unchanged(suite):
    """lens=None: the rows whole, equal to full lengths and to the
    oracle's points of the whole rows; lengths shorter than the rows give
    the oracle's points of the shorter messages."""
    data, arrays = _suite(suite)
    dst = data["dst"].encode()
    rows = np.random.default_rng(22).integers(0, 256, (4, 40), np.uint8)
    pts, ident = arrays(rows, dst, device=CPU)
    full = arrays(rows, dst, np.full(4, 40), device=CPU)
    assert np.array_equal(pts, full[0]) and np.array_equal(ident, full[1])
    assert _ints(pts) == [oracle.point(r.tobytes(), dst, suite == "RO")
                          for r in rows]
    lens = [39, 0, 20, 1]
    short = arrays(rows, dst, np.array(lens), device=CPU)[0]
    assert all((a != b).any() for a, b in zip(pts, short))
    assert _ints(short) == [oracle.point(r[:n].tobytes(), dst, suite == "RO")
                            for r, n in zip(rows, lens)]


@pytest.mark.parametrize("bad", [np.array([1, 2]), np.array([[1, 2, 3]]),
                                 np.array([1, -1, 3]), np.array([1, 9, 3]),
                                 np.array([1.0, 2.0, 3.0])],
                         ids=["short", "2d", "negative", "past_row", "float"])
def test_bad_lengths_raise_value_error(bad):
    rows = np.zeros((3, 8), np.uint8)
    for call in (lambda: h2c.expand_message_xmd_batch(rows, DST, 96, bad),
                 lambda: h2c.hash_to_curve_batch_arrays(rows, DST, bad,
                                                        device=CPU),
                 lambda: h2c.encode_to_curve_batch_arrays(rows, DST, bad,
                                                          device=CPU)):
        with pytest.raises(ValueError, match="lens|length"):
            call()


# --- the counter ----------------------------------------------------------

@pytest.mark.parametrize("n_out", [48, 96])
@pytest.mark.parametrize("dst", [DST, b"x" * 300], ids=["dst49", "dst300"])
def test_host_blocks_follow_the_padding_rule(dst, n_out):
    """b0 hashes 64 + len + 3 + |DST'| bytes, each b_i 32 + 1 + |DST'|
    (DST' the DST as hashed, with its length byte); the counter adds
    their compressions and the messages."""
    lengths = [0, 3, 16, 54, 55, 56, 118, 119, 120, 133, 517]
    rows, lens = _padded([bytes(n) for n in lengths])
    dst_prime = len(dst if len(dst) <= 255 else bytes(32)) + 1
    ell = -(-n_out // 32)
    want = sum(_blocks(64 + n + 3 + dst_prime) for n in lengths) \
        + ell * len(lengths) * _blocks(33 + dst_prime)
    before = dict(h2c.XMD_HOST_BLOCKS)
    h2c.expand_message_xmd_batch(rows, dst, n_out, lens)
    assert h2c.XMD_HOST_BLOCKS == {
        "blocks": before["blocks"] + want,
        "messages": before["messages"] + len(lengths)}
    if dst == DST and n_out == 96:
        # The suite's DST: ceil((126 + len) / 64) for b0, 2 for each b_i.
        assert want == sum(-(-(126 + n) // 64) + 6 for n in lengths)
    h2c.expand_message_xmd_batch(rows, dst, n_out)
    assert h2c.XMD_HOST_BLOCKS["blocks"] == before["blocks"] + want + len(
        lengths) * (_blocks(64 + 517 + 3 + dst_prime)
                    + ell * _blocks(33 + dst_prime))


# --- the expansion kernel's wrapper on the CPU ----------------------------

def _dst_prime(dst):
    return dst + bytes([len(dst)])


@pytest.mark.parametrize("n_out", [48, 96])
def test_expand_xmd_plain_gives_the_host_planes(n_out):
    """`K.expand_xmd` on CPU tensors: the planes of
    `expand_message_xmd_batch` through `byte_plane_np`, u0's lanes then
    u1's for 96 bytes; the 11 lanes past the 21 messages repeat the last;
    every lane the JAX package's one-message expansion."""
    rng = np.random.default_rng(23 + n_out)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in list(range(0, 120, 7)) + [130, 131, 517]]
    rows, lens = _padded(msgs, width=530)
    lanes = bt.bucket(len(msgs))
    got = K.expand_xmd(torch.from_numpy(rows), torch.from_numpy(lens),
                       _dst_prime(DST), n_out, lanes)
    uniform = h2c.expand_message_xmd_batch(rows, DST, n_out, lens)
    want = torch.cat([bt.byte_plane_np(np.ascontiguousarray(
        uniform[:, lo:lo + 48]), lanes, CPU) for lo in range(0, n_out, 48)],
        1)
    assert got.shape == (48, n_out // 48 * lanes) and torch.equal(got, want)
    strings = got.reshape(48, n_out // 48, lanes).permute(2, 1, 0) \
        .reshape(lanes, n_out).numpy()
    for i in range(lanes):
        assert strings[i].tobytes() == jh2c.expand_message_xmd(
            msgs[min(i, len(msgs) - 1)], DST, n_out), i


@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_cores_from_rows_give_the_suite_vectors(suite):
    """`_ro_bytes_core` (`_nu_bytes_core`) from rows, lengths, DST' and the
    lane count: the J.8.1 (J.8.2) vectors' P, as affine byte planes, with
    no identity."""
    data, _ = _suite(suite)
    dst = data["dst"].encode()
    rows, lens = _padded([v["msg"].encode() for v in data["vectors"]])
    core = h2c._ro_bytes_core if suite == "RO" else h2c._nu_bytes_core
    xb, yb, ident = core(torch.from_numpy(rows), torch.from_numpy(lens),
                         _dst_prime(dst), 16)
    n = len(data["vectors"])
    assert xb.shape == (32, 16) and not ident[:n].any()
    for i, v in enumerate(data["vectors"]):
        assert tuple(int.from_bytes(c[:, i].numpy().astype(np.uint8)
                                    .tobytes(), "big") for c in (xb, yb)) == \
            (int(v["P"]["x"], 16), int(v["P"]["y"], 16))


@pytest.mark.parametrize("suite", ["RO", "NU"])
def test_xmd_lanes_and_plain_calls_count_one_call(suite):
    """One arrays call on the CPU adds its messages to XMD_LANES["host"]
    (not the padded lanes), nothing to "device", and one plain call of the
    expansion."""
    _, arrays = _suite(suite)
    rows, lens = _padded([b"abc", b"", b"q" * 70])
    lanes, plain = dict(h2c.XMD_LANES), K.PLAIN_CALLS["expand_xmd"]
    arrays(rows, DST, lens, device=CPU)
    assert h2c.XMD_LANES == {"device": lanes["device"],
                             "host": lanes["host"] + 3}
    assert K.PLAIN_CALLS["expand_xmd"] == plain + 1


@pytest.mark.parametrize("case", ["rows_dtype", "lens_dtype", "lens_shape",
                                  "no_rows", "lanes", "dst_length_byte",
                                  "dst_short", "n_out"])
def test_expand_xmd_wrapper_rejects_bad_operands(case):
    rows, lens = torch.zeros((3, 8), dtype=torch.uint8), \
        torch.zeros(3, dtype=torch.int32)
    args = {"rows": rows, "lens": lens, "dst_prime": _dst_prime(DST),
            "n_out": 96, "lanes": 16}
    args.update({
        "rows_dtype": {"rows": rows.to(torch.int32)},
        "lens_dtype": {"lens": lens.to(torch.int64)},
        "lens_shape": {"lens": lens[:2]},
        "no_rows": {"rows": rows[:0], "lens": lens[:0]},
        "lanes": {"lanes": 2},
        "dst_length_byte": {"dst_prime": DST + b"\x05"},
        "dst_short": {"dst_prime": b"\x00"},
        "n_out": {"n_out": 64}}[case])
    with pytest.raises(ValueError):
        K.expand_xmd(**args)
