"""Host intake of a Taproot verify call: its host milliseconds less the
device span of `_schnorr_verify_e2e_core` inside it (Core's size and
hash-type rules, the challenge hash, the byte planes, the read-back, the
device's wait for the host), mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.call_minus_span_ms(run, "schnorr._schnorr_verify_e2e_core")
