"""RFC 6979's HMAC-SHA256 DRBG of the sign core, on the CPU.

`kernels.rfc6979_nonce` runs `csrc/drbg.cu` `k_rfc6979` for CUDA tensors
and its plain version `rfc6979_nonce_plain` for CPU tensors.  The plain
version is held, candidate by candidate (attempt 0, 1, 2), to

- the native library's `rfc6979_nonce_batch` and `rfc6979_continue`, on
  64 seeded lanes with no additional data, random additional data and
  Bitcoin Core's grind rows (`bitcoin._grind_extra`);
- `tests/wallet_sign_ref.py`'s `nonce_rfc6979` (libsecp256k1's nonce
  function in `hmac`) and, without additional data, the JAX package's
  `DrbgRFC6979`;
- the 20 signatures of `tests/testdata/secp256k1_rfc6979_sha256.csv`,
  rebuilt from its first candidates with python ints.

`tests/test_torch_csrc_host.py` holds the kernel's own lane body, built
for the host, to the native DRBG.  Every comparison is exact.
"""

import csv
import hashlib
import os

import numpy as np
import pytest
import torch

import wallet_sign_ref as ref
from secp256k1_tpu.models.rfc6979 import DrbgRFC6979 as JaxDrbg
from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import bitcoin, codecs, ecdsa
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import hostcurve as hc

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

N = hc.N
LANES = 64
TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


def _plane(rows: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(rows.T))


@pytest.fixture(scope="module")
def rows():
    gen = np.random.default_rng(2026_1017)
    keys = gen.integers(0, 256, (LANES, 32), dtype=np.uint8)
    digests = gen.integers(0, 256, (LANES, 32), dtype=np.uint8)
    digests[5] = 0xFF                      # a digest above n: e = digest - n
    return {"keys": keys, "digests": digests,
            "e": ecdsa._reduce_digest_np(digests),
            "extra": {"none": None,
                      "random": gen.integers(0, 256, (LANES, 32),
                                             dtype=np.uint8),
                      "grind": bitcoin._grind_extra(3, LANES)}}


@pytest.mark.parametrize("attempt", [0, 1, 2])
@pytest.mark.parametrize("extra", ["none", "random", "grind"])
def test_plain_matches_the_native_drbg_and_the_references(rows, extra,
                                                          attempt):
    keys, e, ext = rows["keys"], rows["e"], rows["extra"][extra]
    got = K.rfc6979_nonce(_plane(keys), _plane(e),
                          None if ext is None else _plane(ext), attempt)
    assert got.dtype == torch.uint8 and got.shape == (32, LANES)
    got = got.numpy().T
    want, sv, sk = native.rfc6979_nonce_batch(keys, e, ext)
    for _ in range(attempt):
        want = np.stack([native.rfc6979_continue(sv, sk, i)
                         for i in range(LANES)])
    assert np.array_equal(got, want)
    for i in range(LANES):
        args = (keys[i].tobytes(), rows["digests"][i].tobytes(),
                None if ext is None else ext[i].tobytes())
        assert got[i].tobytes() == ref.nonce_rfc6979(*args, counter=attempt)
        if ext is None:
            drbg = JaxDrbg(keys[i].tobytes(), e[i].tobytes())
            for _ in range(attempt + 1):
                k = drbg.read(32)
            assert got[i].tobytes() == k


def test_plain_gives_the_rfc6979_vectors():
    """Each vector's DER signature from the plain version's first
    candidate: r = x(kG) mod n, s = k^-1 (e + r d) mod n, made low."""
    with open(os.path.join(TESTDATA, "secp256k1_rfc6979_sha256.csv")) as f:
        kat = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    assert len(kat) == 20
    keys = [int(r[0]) for r in kat]
    digests = np.stack([np.frombuffer(hashlib.sha256(r[1].encode()).digest(),
                                      np.uint8) for r in kat])
    e = ecdsa._reduce_digest_np(digests)
    key_rows = np.stack([np.frombuffer(d.to_bytes(32, "big"), np.uint8)
                         for d in keys])
    ks = K.rfc6979_nonce(_plane(key_rows), _plane(e)).numpy().T
    for d, k_row, e_row, row in zip(keys, ks, e, kat):
        k = int.from_bytes(k_row.tobytes(), "big")
        assert 0 < k < N
        r = hc.mul(k, hc.G)[0] % N
        s = pow(k, N - 2, N) * (int.from_bytes(e_row.tobytes(), "big")
                                + r * d) % N
        s = min(s, N - s)
        assert codecs.build_asn1_signature(r, s).hex().upper() == row[2]


def test_wrapper_counts_plain_calls_and_checks_its_planes():
    z = torch.zeros((32, 4), dtype=torch.uint8)
    K.reset_counts()
    assert K.rfc6979_nonce(z, z, z, 1).shape == (32, 4)
    assert K.rfc6979_nonce(z[:, :0].contiguous(), z[:, :0].contiguous()
                           ).shape == (32, 0)
    assert K.PLAIN_CALLS["rfc6979_nonce"] == 2
    assert K.LAUNCHES["rfc6979_nonce"] == 0
    bad = [(z.to(torch.int32), z, None, 0), (z[:31], z[:31], None, 0),
           (z, z[:, :3], None, 0), (z, z, z[:, :3], 0), (z, z, None, -1),
           (z.t().contiguous().t(), z, None, 0)]
    for args in bad:
        with pytest.raises(ValueError):
            K.rfc6979_nonce(*args)
