"""The verify core: CUDA events around `_verify_impl` to its completion,
mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.span_device_ms(run, "ecdsa._verify_impl")
