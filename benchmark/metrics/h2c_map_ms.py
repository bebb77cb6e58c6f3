"""The device map of a hash-to-curve call: CUDA events around
`_ro_bytes_core` (both SWU maps on E', the 3-isogeny, the add, the affine
bytes) to its completion, mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.span_device_ms(run, "h2c._ro_bytes_core")
