"""Device activities (kernels, copies, sets) in the profiled window over
the calls in it."""

import tracing


def read(run):
    return tracing.device_ops_per_call(run)
