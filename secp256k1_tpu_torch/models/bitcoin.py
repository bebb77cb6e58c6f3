"""Bitcoin consensus validation: BIP-0066 strict DER and consensus ECDSA
verify.

The port of `secp256k1_tpu.models.bitcoin`: the same BIP-0066 checks in
the same order (a signature carries its trailing sighash byte), then ECDSA
verify with SHA-256 digests, ASN.1 signatures and low s enforced.  Entry
points take `device=None`, which means the GPU, and raise when there is
none; `device="cpu"` runs the plain path.
"""

from __future__ import annotations

import numpy as np

from ..utils import batching as bt
from ..utils import config as cfg
from ..utils import errors as ec
from . import ecdsa as ecdsamod

_TAG_SEQUENCE_COMPOUND = 0x30
_TAG_INTEGER = 0x02

_OPTS_CONSENSUS = cfg.ECDSAOptions(
    hash="sha256",
    encoding=cfg.SignatureEncoding.ASN1,
    reject_malleable=True,
)


def is_valid_signature_encoding_bip0066(data: bytes) -> bool:
    """BIP-0066 validator, the trailing sighash byte included."""
    len_sig = len(data)
    if len_sig < 9 or len_sig > 73:
        return False
    if data[0] != _TAG_SEQUENCE_COMPOUND:
        return False
    if data[1] != len_sig - 3:
        return False
    len_r = data[3]
    if 5 + len_r >= len_sig:
        return False
    len_s = data[5 + len_r]
    if len_r + len_s + 7 != len_sig:
        return False
    if data[2] != _TAG_INTEGER:
        return False
    if len_r == 0:
        return False
    if data[4] & 0x80:
        return False
    if len_r > 1 and data[4] == 0x00 and not data[5] & 0x80:
        return False
    if data[len_r + 4] != _TAG_INTEGER:
        return False
    if len_s == 0:
        return False
    if data[len_r + 6] & 0x80:
        return False
    if len_s > 1 and data[len_r + 6] == 0x00 and not data[len_r + 7] & 0x80:
        return False
    return True


def verify_asn1(pub, digest: bytes, sig: bytes, device=None) -> bool:
    """Consensus verify of one signature: BIP-0066 encoding and low s."""
    device = bt.resolve_device(device)
    if not is_valid_signature_encoding_bip0066(sig):
        return False
    return ecdsamod.verify(pub, digest, sig[:-1], opts=_OPTS_CONSENSUS,
                           device=device)


def bip0066_valid_np(sigs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """BIP-0066 over zero-padded rows: sigs [n, max_len] u8, lens [n]
    lengths with the sighash byte.  Returns [n] bool.  The checks of
    `is_valid_signature_encoding_bip0066` in its order; a read past a row
    is clipped, harmless because every condition is ANDed and such a lane
    has already failed."""
    n, max_len = sigs.shape
    ls = lens.astype(np.int64)
    s = sigs.astype(np.int64)
    rows = np.arange(n)

    def at(idx):
        return s[rows, np.clip(idx, 0, max_len - 1)]

    ok = (ls >= 9) & (ls <= 73) & (ls <= max_len)
    ok &= at(np.full(n, 0)) == _TAG_SEQUENCE_COMPOUND
    ok &= at(np.full(n, 1)) == ls - 3
    len_r = at(np.full(n, 3))
    ok &= 5 + len_r < ls
    len_s = at(5 + len_r)
    ok &= len_r + len_s + 7 == ls
    ok &= at(np.full(n, 2)) == _TAG_INTEGER
    ok &= len_r != 0
    ok &= (at(np.full(n, 4)) & 0x80) == 0
    ok &= ~((len_r > 1) & (at(np.full(n, 4)) == 0)
            & ((at(np.full(n, 5)) & 0x80) == 0))
    ok &= at(len_r + 4) == _TAG_INTEGER
    ok &= len_s != 0
    ok &= (at(len_r + 6) & 0x80) == 0
    ok &= ~((len_s > 1) & (at(len_r + 6) == 0)
            & ((at(len_r + 7) & 0x80) == 0))
    return ok


def verify_asn1_batch_arrays(pubs_sec1: np.ndarray, digests: np.ndarray,
                             sigs: np.ndarray, lens: np.ndarray,
                             chunk_lanes: int | None = None,
                             device=None) -> np.ndarray:
    """Batched consensus verify on numpy arrays: BIP-0066 over the rows,
    the sighash byte stripped, then `ecdsa.verify_batch_arrays` with low s
    enforced.  Returns [n] int32 status codes; a BIP-0066 failure is
    ERR_INVALID_ENCODING."""
    device = bt.resolve_device(device)
    enc_ok = bip0066_valid_np(sigs, lens)
    stripped_lens = np.where(enc_ok, lens - 1, 2).astype(np.int32)
    sig_in = sigs.copy()
    sig_in[~enc_ok, :2] = (0x30, 0x00)                 # inert placeholder
    st = ecdsamod.verify_batch_arrays(
        pubs_sec1, digests, sig_in, stripped_lens, reject_malleable=True,
        chunk_lanes=chunk_lanes, device=device)
    return np.where(enc_ok, st, ec.ERR_INVALID_ENCODING).astype(np.int32)


def verify_asn1_batch(pubs, digests, sigs, device=None) -> list:
    """Consensus verify of lists: [bool] a signature."""
    device = bt.resolve_device(device)
    enc_ok = [is_valid_signature_encoding_bip0066(s) for s in sigs]
    stripped = [s[:-1] if ok else b"\x30\x00" for s, ok in zip(sigs, enc_ok)]
    dev_ok = ecdsamod.verify_batch(pubs, digests, stripped,
                                   opts=_OPTS_CONSENSUS, device=device)
    return [a and b for a, b in zip(enc_ok, dev_ok)]
