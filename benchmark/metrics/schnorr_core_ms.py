"""The Schnorr verify core: CUDA events around `_schnorr_verify_e2e_core`
(the x-only key lift, r and s, R = s G - e P by #4 and #5, the parity and
x(R) = r) to its completion, mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.span_device_ms(run, "schnorr._schnorr_verify_e2e_core")
