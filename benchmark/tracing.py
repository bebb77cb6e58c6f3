"""Spans around the program's layers and the reading of a profiler trace.

`Spans` wraps module-level functions of the program at run time (their
callers look them up as module globals), from the benchmark's own files:
each call records its host interval, CUDA events around it where it runs
on the card, and, while the profiler runs, a `bench:<label>` annotation
that names what the host was doing.  `read_profile` reduces a
`torch.profiler` session to the device's activities inside the
`bench:window` annotation.  The helpers at the end are what the metric
readers under `metrics/` call.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time

WINDOW = "bench:window"
CALL = "bench:call"
TOP = 10


class Spans:
    """Records of the wrapped functions: label -> [(host start, host end,
    (start event, end event) or None)]."""

    def __init__(self, specs, device_events: bool):
        self.specs, self.device_events = specs, device_events
        self.records = {}
        self.annotate = False
        self._saved = []

    @staticmethod
    def label(module: str, name: str) -> str:
        return f"{module.rsplit('.', 1)[-1]}.{name}"

    def install(self):
        for module, name, on_device in self.specs:
            mod = importlib.import_module(module)
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(self.label(module, name), fn,
                                          on_device and self.device_events))

    def remove(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def _wrap(self, label, fn, on_device):
        import torch
        recs = self.records.setdefault(label, [])

        def wrapper(*args, **kwargs):
            ev = None
            t0 = time.perf_counter()
            if on_device:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with annotation(f"bench:{label}", self.annotate):
                out = fn(*args, **kwargs)
            if on_device:
                ev[1].record()
            recs.append((t0, time.perf_counter(), ev))
            return out
        wrapper.__wrapped__ = fn
        return wrapper

    def resolved(self) -> dict:
        """label -> [(host start, host end, device ms or None)], once every
        recorded event has completed."""
        return {label: [(t0, t1, None if ev is None
                         else ev[0].elapsed_time(ev[1]))
                        for t0, t1, ev in recs]
                for label, recs in self.records.items()}


def annotation(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def _union(intervals):
    """Merged [start, end] intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof) -> dict:
    """The device's activities (kernels, copies, sets) inside the
    `bench:window` annotation of a profiler session, in microseconds of the
    profiler's clock: {"window": (start, end), "ops": [(name, start, end)],
    "notes": [(name, start, end)]} with notes the host's `bench:`
    annotations."""
    from torch.autograd import DeviceType
    ops, notes, window = [], [], None
    for ev in prof.events():
        name = ev.name
        start, end = ev.time_range.start, ev.time_range.end
        if name.startswith("bench:"):
            if ev.device_type == DeviceType.CPU:
                if name == WINDOW:
                    window = (start, end)
                else:
                    notes.append((name[len("bench:"):], start, end))
            continue
        if ev.device_type == DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            ops.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler kept no record of the window")
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
           if e > lo and s < hi]
    return {"window": window, "ops": ops, "notes": notes}


def busy_s(profile: dict) -> float:
    return sum(e - s for s, e in _union(
        [(s, e) for _, s, e in profile["ops"]])) / 1e6


def window_s(profile: dict) -> float:
    lo, hi = profile["window"]
    return (hi - lo) / 1e6


def breakdown(profile: dict) -> dict:
    """The device operations that took most time, and the device's idle
    time by the innermost `bench:` annotation the host was inside (the
    call itself where no wrapped layer was running, the harness outside
    any call)."""
    by_op = {}
    for name, s, e in profile["ops"]:
        key = name if len(name) <= 120 else name[:117] + "..."
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
    lo, hi = profile["window"]
    busy = _union([(s, e) for _, s, e in profile["ops"]])
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    notes = sorted(profile["notes"], key=lambda n: n[1])
    starts = [n[1] for n in notes]
    by_host = {}
    for s, e in gaps:
        mid = (s + e) / 2
        label = "harness"
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0:
            if notes[j][2] >= mid:
                label = notes[j][0]
                break
            j -= 1
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


# ---------------------------------------------------------------------------
# What the metric readers call.  `run` is the harness's record of one run
# (harness.Run); a reader returns None where it finds nothing to read.
# ---------------------------------------------------------------------------

def span_device_ms(run, label: str):
    """Mean device milliseconds of the label's spans over the calls of
    the span-timed part of the window (CUDA events, start to completion)."""
    vals = [ms for _, _, ms in run.spans_in_calls(label) if ms is not None]
    return sum(vals) / len(vals) if vals else None


def call_minus_span_ms(run, label: str):
    """Mean over the span-timed calls of each call's host milliseconds
    less the device milliseconds of the label's spans inside it."""
    calls = run.span_calls()
    spans = run.spans_in_calls(label)
    if not calls or not spans or any(ms is None for _, _, ms in spans):
        return None
    starts = [s for s, _, _ in spans]
    total = 0.0
    for c in calls:
        lo = bisect.bisect_left(starts, c.t0)
        hi = bisect.bisect_right(starts, c.t1)
        total += (c.t1 - c.t0) * 1e3 - sum(ms for _, _, ms in spans[lo:hi])
    return total / len(calls)


def idle_pct(run):
    if run.profile is None:
        return None
    w = window_s(run.profile)
    return 100.0 * (1.0 - busy_s(run.profile) / w) if w > 0 else None


def device_ops_per_call(run):
    if run.profile is None or not run.profiled_calls:
        return None
    return len(run.profile["ops"]) / len(run.profiled_calls)


def roofline_pct(run, kernel: str):
    """The kernel's share of its roofline: the least time of the work the
    profiled calls gave it (the yardstick's count) over the device time of
    its launches in them.  None where fewer launches of a kernel whose
    name holds `kernel` were recorded than calls were profiled."""
    import yardstick
    if run.profile is None or run.int_rate is None:
        return None
    times = [e - s for n, s, e in run.profile["ops"] if kernel in n]
    works = [run.work_of(c).get(kernel) for c in run.profiled_calls]
    if not works or len(times) < len(works) \
            or any(w is None for w in works):
        return None
    bound = sum(yardstick.bound_ms(run.int_rate, *w)[0] for w in works)
    return 100.0 * bound / (sum(times) / 1e3)
