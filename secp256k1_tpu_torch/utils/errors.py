"""Per-lane status codes, the same numbers as `secp256k1_tpu.utils.errors`;
ERR_SCHNORR_SIG_HASHTYPE is the port's own (Taproot consensus verify).

Device code returns int32 status planes; host wrappers map them to Python
exceptions or error strings per lane.  The port keeps its own copy so that it
never imports the JAX package.
"""

OK = 0
ERR_INVALID_ENCODING = 1      # malformed/non-canonical encoding
ERR_NOT_ON_CURVE = 2          # decompression/decode failed curve membership
ERR_INVALID_PUBLIC_KEY = 3    # identity / invalid public key
ERR_INVALID_SCALAR = 4        # non-canonical or zero scalar
ERR_INVALID_DIGEST = 5        # digest length mismatch
ERR_INVALID_SIGNATURE = 6     # r/s out of range or zero
ERR_VERIFY_FAILED = 7         # generic verification failure (Schnorr etc.)
ERR_INVALID_RECOVERY_ID = 8
ERR_MALLEABLE = 9             # s > n/2 when RejectMalleable
ERR_R_IS_INFINITY = 10        # u1*G + u2*Q = identity
ERR_V_NEQ_R = 11              # x(R) mod n != r
ERR_SCHNORR_SIG_HASHTYPE = 12  # BIP-0341: a 65-byte signature's hash type

MESSAGES = {
    OK: "ok",
    ERR_INVALID_ENCODING: "invalid encoding",
    ERR_NOT_ON_CURVE: "point not on curve",
    ERR_INVALID_PUBLIC_KEY: "invalid public key",
    ERR_INVALID_SCALAR: "invalid scalar",
    ERR_INVALID_DIGEST: "invalid digest",
    ERR_INVALID_SIGNATURE: "invalid signature",
    ERR_VERIFY_FAILED: "signature verification failed",
    ERR_INVALID_RECOVERY_ID: "invalid recovery id",
    ERR_MALLEABLE: "malleable signature rejected",
    ERR_R_IS_INFINITY: "R is the point at infinity",
    ERR_V_NEQ_R: "v does not equal r",
    ERR_SCHNORR_SIG_HASHTYPE: "invalid Schnorr signature hash type",
}

# Verification-failure class: every code a failed ECDSA/Schnorr verify can
# produce.
VERIFY_FAILURES = frozenset(
    {ERR_VERIFY_FAILED, ERR_R_IS_INFINITY, ERR_V_NEQ_R})
