"""The MSM call outside its window sums: host milliseconds of the call
less the window sums' device span (upload, byte conversion, decode, the
fold, the encoding and its read-back), mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.call_minus_span_ms(run, "msm.pippenger_window_sums")
