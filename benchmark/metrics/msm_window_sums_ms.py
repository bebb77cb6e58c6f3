"""The MSM's window sums: CUDA events around `pippenger_window_sums`
(the bucket kernel #8, the lane merge, the weighted sums) to their
completion, mean over the span-timed calls."""

import tracing


def read(run):
    return tracing.span_device_ms(run, "msm.pippenger_window_sums")
