"""Kernel #6 `k_base_scan` (the constant-time k * G of signing) against
its roofline: the work of the lanes the reference signed over every
round (`yardstick_sign.py`) over the kernel's device time in the profiled
calls."""

import tracing


def read(run):
    return tracing.roofline_pct(run, "k_base_scan")
