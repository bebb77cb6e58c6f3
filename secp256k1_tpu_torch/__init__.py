"""secp256k1_tpu_torch: batch-first secp256k1 on PyTorch and CUDA.

The port of `secp256k1_tpu` (the JAX package) to an NVIDIA H100: field and
scalar arithmetic on [16, B] int32 limb planes, the complete projective
group law, GLV, fixed-base and Pippenger scalar multiplication, ECDSA
(RFC 6979, recovery), BIP-0340 Schnorr, ECDH, SEC1 and ASN.1/BIP-0066
codecs, RFC 9380 hash-to-curve, the verify service and sharding over
`torch.distributed` (`parallel/`), each hot operation a hand-written CUDA
kernel (`ops/cuda/csrc`).  Entry points run on the GPU unless given
`device="cpu"`.  Importing builds nothing: the kernels and the native host
library build at first use.

Quick start (single-key convenience API; the batched `*_batch` functions in
`secp256k1_tpu_torch.models.*` are the throughput path):

    from secp256k1_tpu_torch import keys, ecdsa
    priv = keys.generate_key()
    sig = ecdsa.sign(priv, digest)
    assert ecdsa.verify(priv.public_key, digest, sig)
"""

__version__ = "0.1.0"

from .models import bitcoin, codecs, ecdh, ecdsa, h2c, keys, schnorr  # noqa: F401
from .models.keys import PrivateKey, PublicKey, generate_key  # noqa: F401
from .models.rfc6979 import RFC6979SHA256  # noqa: F401
from .models.schnorr import SchnorrPrivateKey, SchnorrPublicKey  # noqa: F401
from .utils.config import BatchConfig, ECDSAOptions, SignatureEncoding  # noqa: F401
