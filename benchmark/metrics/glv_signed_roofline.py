"""Kernel #4 `k_glv_signed` (u2 Q by GLV) against its roofline: the
yardstick's work of the calls' lanes over the kernel's device time."""

import tracing


def read(run):
    return tracing.roofline_pct(run, "k_glv_signed")
