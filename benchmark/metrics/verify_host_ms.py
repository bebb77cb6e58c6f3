"""Host intake of a verify call: its host milliseconds less the device
span of `_verify_impl` inside it (BIP-0066, DER parse, marshalling, the
device's wait for the host), mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.call_minus_span_ms(run, "ecdsa._verify_impl")
