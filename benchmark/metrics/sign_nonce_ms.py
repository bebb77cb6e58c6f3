"""Host nonce derivation of a signing call: host milliseconds inside
`native.rfc6979_nonce_batch` (the RFC 6979 DRBG seedings), summed over
the call's rounds, mean over the span-timed calls."""

import spans_per_call


def read(run):
    return spans_per_call.summed_ms(run, "native.rfc6979_nonce_batch", False)
