"""Options of the signing and verifying entry points: a copy of
`secp256k1_tpu.utils.config`, so that the port never imports the JAX
package."""

from __future__ import annotations

import dataclasses
import enum


class SignatureEncoding(enum.Enum):
    ASN1 = "asn1"                       # SEQUENCE { r INTEGER, s INTEGER }
    COMPACT = "compact"                 # [R | S], 64 bytes
    COMPACT_RECOVERABLE = "compact_recoverable"  # [R | S | V], 65 bytes


# Digest sizes accepted per hash name (input validation only).
HASH_SIZES = {
    "sha256": 32,
    "sha512": 64,
    "sha384": 48,
    "sha3_256": 32,
    "sha3_384": 48,
    "sha3_512": 64,
}


@dataclasses.dataclass
class ECDSAOptions:
    hash: str = "sha256"
    encoding: SignatureEncoding = SignatureEncoding.ASN1
    self_verify: bool = False
    reject_malleable: bool = False


@dataclasses.dataclass
class BatchConfig:
    """Device batching knobs."""
    min_bucket: int = 16        # smallest padded batch
    max_bucket: int = 1 << 16   # largest single launch

    def bucket(self, n: int) -> int:
        if n > self.max_bucket:
            raise ValueError(
                f"batch of {n} lanes exceeds max_bucket={self.max_bucket}; "
                "raise max_bucket or chunk the input")
        b = self.min_bucket
        while b < n:
            b <<= 1
        return b


DEFAULT_BATCH = BatchConfig()
