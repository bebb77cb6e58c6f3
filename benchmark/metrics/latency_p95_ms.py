"""The 95th percentile of the calls' times, send to result on the host,
over every call of the window (one caller: a call is sent when the last
one returns)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([(c.t1 - c.t0) * 1e3 for c in run.calls],
                               95))
