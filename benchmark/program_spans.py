"""The program's own spans inside the profiled calls.

The program records spans while torch.profiler runs
(`secp256k1_tpu_torch.utils.profiling.spans()`: records with `name`, `id`,
`parent`, host `t0` and `t1` on `time.perf_counter`, `counts`, and
`device_ms`), so a traced run holds them for the calls of its profiled
tail.  A program without them reads as None.
"""

from __future__ import annotations


def records():
    """The program's span records, or None where it keeps none."""
    try:
        from secp256k1_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def per_call(run):
    """For each profiled call, the records inside its host interval; None
    where the program keeps no spans or no call was profiled."""
    recs = records()
    if recs is None or not run.profiled_calls:
        return None
    return [[r for r in recs if c.t0 <= r.t0 and r.t1 <= c.t1]
            for c in run.profiled_calls]


def host_ms(r) -> float:
    return (r.t1 - r.t0) * 1e3


def summed_host_ms(run, suffix: str):
    """Mean over the profiled calls of the host milliseconds of each
    call's spans whose name ends with `suffix`, summed within the call;
    None where a call has none."""
    calls = per_call(run)
    if not calls:
        return None
    sums = []
    for recs in calls:
        inside = [host_ms(r) for r in recs if r.name.endswith(suffix)]
        if not inside:
            return None
        sums.append(sum(inside))
    return sum(sums) / len(sums)


def self_ms(run, name: str):
    """Mean over the profiled calls of the self time of each call's `name`
    spans (a span's host milliseconds less its children's), summed within
    the call; None where a call has none."""
    calls = per_call(run)
    if not calls:
        return None
    sums = []
    for recs in calls:
        spans = [r for r in recs if r.name == name]
        if not spans:
            return None
        ids = {r.id for r in spans}
        children = sum(host_ms(r) for r in recs if r.parent in ids)
        sums.append(sum(host_ms(r) for r in spans) - children)
    return sum(sums) / len(sums)


def share_pct(run, suffix: str, key: str, value) -> float | None:
    """The share, in percent, of the profiled calls' spans whose name ends
    with `suffix` and that carry `key`, that read `value`; None where none
    carries it."""
    calls = per_call(run)
    if not calls:
        return None
    got = [r.counts[key] for recs in calls for r in recs
           if r.name.endswith(suffix) and key in r.counts]
    if not got:
        return None
    return 100.0 * sum(v == value for v in got) / len(got)
