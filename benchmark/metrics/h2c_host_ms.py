"""The host part of a hash-to-curve call: its host milliseconds less the
device span of `_ro_bytes_core` inside it (the lengths' checks, the
expansion, the byte planes, the read-back, the device's wait for the
host), mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.call_minus_span_ms(run, "h2c._ro_bytes_core")
