"""Bitcoin consensus validation (BIP-0066 strict DER and consensus ECDSA
verify, BIP-0341 Taproot Schnorr verify) and Bitcoin Core's wallet signer.

The port of `secp256k1_tpu.models.bitcoin`: the same BIP-0066 checks in
the same order (a signature carries its trailing sighash byte), then ECDSA
verify with SHA-256 digests, ASN.1 signatures and low s enforced.  Beside
it, `verify_taproot_batch_arrays` checks Taproot signatures as Bitcoin
Core's `CheckSchnorrSignature` does, and `sign_der_batch_arrays` signs as
Bitcoin Core's `CKey::Sign` does (RFC 6979 nonces, low-R grinding, low s,
strict DER and the sighash byte).
Entry points take `device=None`, which means the GPU, and raise when there
is none; `device="cpu"` runs the plain path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..utils import batching as bt
from ..utils import config as cfg
from ..utils import errors as ec
from ..utils import hostcurve as hc
from ..utils import profiling
from . import ecdsa as ecdsamod
from . import schnorr as schnorrmod

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
    has already failed.

    The NumPy form, kept for the benchmark's control and the tests:
    consensus verify (`verify_asn1_batch_arrays`) runs the same checks in
    the native DER parse, `native.bip0066_sig_parse_batch`."""
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
    """Batched consensus verify on numpy arrays, each row parsed once: one
    native pass checks BIP-0066 and parses the DER without its sighash byte
    (`native.bip0066_sig_parse_batch`), then `ecdsa.verify_batch_arrays`'s
    path with low s enforced.  Returns [n] int32 status codes; a BIP-0066
    failure is ERR_INVALID_ENCODING, ahead of every other status."""
    return ecdsamod._verify_arrays(
        pubs_sec1, digests, sigs, lens, reject_malleable=True,
        chunk_lanes=chunk_lanes, pub_lens=None,
        device=bt.resolve_device(device),
        parse=native.bip0066_sig_parse_batch)


def verify_asn1_batch(pubs, digests, sigs, device=None) -> list:
    """Consensus verify of lists: [bool] a signature."""
    device = bt.resolve_device(device)
    enc_ok = [is_valid_signature_encoding_bip0066(s) for s in sigs]
    stripped = [s[:-1] if ok else b"\x30\x00" for s, ok in zip(sigs, enc_ok)]
    dev_ok = ecdsamod.verify_batch(pubs, digests, stripped,
                                   opts=_OPTS_CONSENSUS, device=device)
    return [a and b for a, b in zip(enc_ok, dev_ok)]


# ---------------------------------------------------------------------------
# Taproot (BIP-0341, BIP-0342) signature checks.
# ---------------------------------------------------------------------------

# The hash types a 65-byte signature may name: SIGHASH_DEFAULT (0x00) is
# implied by a 64-byte one and may not be explicit.
_TAPROOT_HASH_TYPES = (0x01, 0x02, 0x03, 0x81, 0x82, 0x83)
# What a lane rejected on the host sends to the device: the key x(G) and
# the signature (x(G), 1), in range and liftable.
_INERT_X = np.frombuffer(hc.GX.to_bytes(32, "big"), np.uint8)
_INERT_SIG = np.concatenate([_INERT_X, np.frombuffer(
    (1).to_bytes(32, "big"), np.uint8)])


def _taproot_host_parse(pub_x: np.ndarray, sigs: np.ndarray,
                        lens: np.ndarray):
    """Core's size and hash-type rules over the rows, ahead of BIP-0340
    verify: a length other than 64 or 65 is ERR_INVALID_ENCODING (Core's
    SCHNORR_SIG_SIZE); a 65-byte row whose last byte is not in
    `_TAPROOT_HASH_TYPES` is ERR_SCHNORR_SIG_HASHTYPE.  Returns (status [n]
    int32, OK where the lane goes on to verify; keys [n, 32]; signatures
    [n, 64]), the rejected lanes' keys and signatures made inert."""
    lens = np.asarray(lens)
    size_ok = (lens == 64) | (lens == 65)
    type_ok = (lens != 65) | np.isin(sigs[:, 64], _TAPROOT_HASH_TYPES)
    status = np.where(size_ok, np.where(type_ok, ec.OK,
                                        ec.ERR_SCHNORR_SIG_HASHTYPE),
                      ec.ERR_INVALID_ENCODING).astype(np.int32)
    keys = np.array(pub_x, np.uint8)
    sig64 = np.array(sigs[:, :64], np.uint8)
    rejected = status != ec.OK
    keys[rejected] = _INERT_X
    sig64[rejected] = _INERT_SIG
    return status, keys, sig64


def verify_taproot_batch_arrays(pub_x: np.ndarray, digests: np.ndarray,
                                sigs: np.ndarray, lens: np.ndarray,
                                device=None) -> np.ndarray:
    """Batched Taproot signature checks as Bitcoin Core's
    `GenericTransactionSignatureChecker::CheckSchnorrSignature` makes them
    (BIP-0341 key-path spends, BIP-0342 tapscript signatures).

    pub_x: [n, 32] u8 x-only output keys; digests: [n, 32] u8 TapSighash
    digests; sigs: [n, W] u8 signatures zero-padded, W >= 65; lens: [n]
    their lengths.  Returns [n] int32 statuses in Core's precedence:
    ERR_INVALID_ENCODING for a length other than 64 or 65 (a longer
    signature needs only its length here), ERR_SCHNORR_SIG_HASHTYPE for
    an explicit hash type of 0x00 or outside 0x01-0x03 and 0x81-0x83, else
    ERR_VERIFY_FAILED where BIP-0340 verify of the first 64 bytes fails
    (a key x >= p or off the curve, r >= p, s >= n, R at infinity, odd
    y(R) or x(R) != r), else OK.  The host applies the rules
    (`_taproot_host_parse`); the device hashes every lane's challenge and
    verifies (`schnorr._verify_status_arrays`)."""
    device = bt.resolve_device(device)
    n = pub_x.shape[0]
    if pub_x.shape != (n, 32) or digests.shape != (n, 32) \
            or sigs.ndim != 2 or sigs.shape[0] != n or sigs.shape[1] < 65 \
            or np.shape(lens) != (n,):
        raise ValueError(f"expected [n, 32] keys and digests, [n, >= 65] "
                         f"sigs and [n] lens, got {pub_x.shape}, "
                         f"{digests.shape}, {sigs.shape}, {np.shape(lens)}")
    with profiling.entry("schnorr"):
        with profiling.span("schnorr.parse"):
            status, keys, sig64 = _taproot_host_parse(pub_x, sigs, lens)
        core = schnorrmod._verify_status_arrays(keys, digests, sig64, None,
                                                device)
        with profiling.span("schnorr.readback"):
            return np.where(status != ec.OK, status,
                            np.where(core == ec.OK, ec.OK,
                                     ec.ERR_VERIFY_FAILED)).astype(np.int32)


# ---------------------------------------------------------------------------
# Bitcoin Core's wallet signer.
# ---------------------------------------------------------------------------

# Core grinds until r is low, with no cap; a lane needs more than c
# attempts with probability 2^-c.
MAX_GRIND_ROUNDS = 256
DER_ROW_BYTES = 72


@dataclass
class SignStats:
    """Counters of one `sign_der_batch_arrays` call, filled by the call
    given it: the rounds it ran (round 0 included) and its RFC 6979 DRBG
    seedings (one a lane a round; a resample continues a seeded DRBG and
    is not counted)."""
    rounds: int = 0
    seedings: int = 0
    signatures: int = 0


def _grind_extra(counter: int, lanes: int) -> np.ndarray:
    """Core's extra entropy for attempt `counter`: WriteLE32 of the
    counter, then 28 zero bytes, in every lane."""
    rows = np.zeros((lanes, 32), np.uint8)
    rows[:, :4] = np.frombuffer(counter.to_bytes(4, "little"), np.uint8)
    return rows


def sign_der_batch_arrays(priv_bytes: np.ndarray, digests: np.ndarray,
                          sighash: int = 1, grind: bool = True, device=None,
                          stats: SignStats | None = None):
    """Batched signing as Bitcoin Core's wallet signs an input
    (`CKey::Sign` over libsecp256k1's `nonce_function_rfc6979`), with
    nothing kept between calls.

    priv_bytes: [n, 32] u8 big-endian private scalars; digests: [n, 32] u8
    sighash digests.  Round 0 signs every lane by `ecdsa.sign_batch_arrays`
    with no additional data.  With `grind`, each round c >= 1 signs again
    only the lanes whose r is still at least 2^255 (its DER integer would
    take a 0x00 pad), with the additional data LE32(c) || 0^28, until no
    lane is left.  s is low.  Returns (der [n, 72] u8, lens [n] int32,
    status [n] int32): the strict DER signature and the sighash byte, at
    most 71 bytes once ground, zero past its length.  A lane whose key is
    not in [1, n) gets ERR_INVALID_SCALAR, a zero row and length 0.
    `stats`, where given, receives the call's counters.  Each round is a
    `sign.round` span (its `lanes` and `round`), the encoding `sign.der`."""
    n = priv_bytes.shape[0]
    with profiling.entry("sign"):
        with profiling.span("sign.round") as sp:
            sp.lanes, sp.round = n, 0
            sigs, _, status = ecdsamod.sign_batch_arrays(
                priv_bytes, digests, device=device)
            todo = np.nonzero(sigs[:, 0] >= 0x80)[0] if grind \
                else np.zeros(0, np.int64)
        rounds, seedings = 1, n
        while todo.size:
            if rounds == MAX_GRIND_ROUNDS:
                raise RuntimeError(f"{todo.size} lanes still high-R after "
                                   f"{rounds} rounds")
            with profiling.span("sign.round") as sp:
                sp.lanes, sp.round = todo.size, rounds
                again, _, _ = ecdsamod.sign_batch_arrays(
                    priv_bytes[todo], digests[todo], device=device,
                    extra=_grind_extra(rounds, todo.size))
                sigs[todo] = again
                seedings += todo.size
                rounds += 1
                todo = todo[again[:, 0] >= 0x80]
        with profiling.span("sign.der"):
            der, lens = native.der_sig_encode_batch(sigs[:, :32],
                                                    sigs[:, 32:], sighash)
            bad = status != ec.OK
            der[bad] = 0
            lens[bad] = 0
            der = np.ascontiguousarray(der[:, :DER_ROW_BYTES])
    if stats is not None:
        stats.rounds, stats.seedings, stats.signatures = rounds, seedings, n
    return der, lens, status
