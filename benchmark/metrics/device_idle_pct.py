"""The device's idle share of the profiled window: 1 - the union of its
activities' intervals (kernels, copies, sets) over the window."""

import tracing


def read(run):
    return tracing.idle_pct(run)
