"""Span readings summed within each call: for a layer that a call enters
more than once (the signer's rounds), the sum of its spans inside each
span-timed call, mean over those calls."""

from __future__ import annotations

import bisect


def summed_ms(run, label: str, device: bool):
    """Mean over the span-timed calls of the label's spans inside each
    call, summed: their device milliseconds (CUDA events) where `device`,
    else their host milliseconds.  None where a call has none."""
    calls = run.span_calls()
    spans = run.spans_in_calls(label)
    if not calls or not spans:
        return None
    if device and any(ms is None for _, _, ms in spans):
        return None
    starts = [s for s, _, _ in spans]
    total = 0.0
    for c in calls:
        inside = spans[bisect.bisect_left(starts, c.t0):
                       bisect.bisect_right(starts, c.t1)]
        if not inside:
            return None
        total += sum(ms if device else (t1 - t0) * 1e3
                     for t0, t1, ms in inside)
    return total / len(calls)
