"""Kernel #8 `k_msm_buckets` (every window's bucket accumulation)
against its roofline: the yardstick's work of the calls' digits over the
kernel's device time."""

import tracing


def read(run):
    return tracing.roofline_pct(run, "k_msm_buckets")
