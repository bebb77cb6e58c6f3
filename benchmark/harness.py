"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json     the deployment (its `entry` names the code)
    entries/<entry>.py        pool and ring generator, the timed call, its
                              control and the reference's answers
    traffic/<traffic>.json    the mix's parameters, read by the entry
    metrics/<metric>.py       read(run) -> a number, or None; a name
                              with a suffix (`<base>.<cell kind>`) falls
                              back to `metrics/<base>.py`

An entry module defines `Cell(config, mix, seed)` with `ring`, `bind`,
`call`, `control`, `expected`, `mismatches` and `work`, and `SPANS` (the
program's functions a traced run wraps) and `CHECK` (the name of the
number compared).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import traceback

import tracing

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP_CALLS = 2
# The profiled tail of a traced window: torch.profiler records some
# thousands of events a verify call, and reading them back takes about a
# minute for every ten seconds profiled on the H100's host.
PROFILE_SECONDS = 2.0
# Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "secp256k1_tpu")


def load_module(path: str):
    name = "bench_" + os.path.relpath(path, HERE).replace(os.sep, "_") \
        .replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Names in sys.modules whose top-level package is forbidden, compared
    whole (`secp256k1_tpu_torch` is not `secp256k1_tpu`)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def metric_path(name: str) -> str:
    """The reader of a metric: `metrics/<name>.py`, else, for a name split
    by cell kind such as `device_idle_pct.latency`, the reader of its base
    name before the first dot, `metrics/device_idle_pct.py`."""
    exact = os.path.join(HERE, "metrics", name + ".py")
    if os.path.exists(exact) or "." not in name:
        return exact
    return os.path.join(HERE, "metrics", name.split(".", 1)[0] + ".py")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class CellSpec:
    """A cell of BENCHMARK.json with its files read."""

    def __init__(self, bench: dict, root: str, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        self.workload = cells[workload]
        self.chips = self.workload["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        with open(os.path.join(root, conf["file"])) as fh:
            self.config = json.load(fh)
        with open(os.path.join(HERE, "traffic",
                               self.workload["traffic"] + ".json")) as fh:
            self.mix = json.load(fh)
        self.entry_path = os.path.join(HERE, "entries",
                                       self.config["entry"] + ".py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, workload)]


def load_cell(root: str, workload: str) -> CellSpec:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return CellSpec(json.load(fh), root, workload)


class Call:
    __slots__ = ("t0", "t1", "idx", "phase", "out", "error")

    def __init__(self, t0, t1, idx, phase, out, error):
        self.t0, self.t1, self.idx, self.phase = t0, t1, idx, phase
        self.out, self.error = out, error


class Run:
    """The record of one run that the metric readers read."""

    def __init__(self, cell, setup_s: float):
        self.cell, self.setup_s = cell, setup_s
        self.calls = []              # every call of the window, in order
        self.window = (0.0, 0.0)     # host start and end of the window
        self.spans = {}              # label -> [(t0, t1, device ms)]
        self.profile = None
        self.profiled_calls = []
        self.int_rate = None
        self._work = {}

    def span_calls(self) -> list:
        return [c for c in self.calls if c.phase == "spans"]

    def spans_in_calls(self, label: str) -> list:
        calls = self.span_calls()
        if not calls:
            return []
        lo, hi = calls[0].t0, calls[-1].t1
        return sorted(s for s in self.spans.get(label, ())
                      if lo <= s[0] <= hi)

    def work_of(self, call: Call) -> dict:
        if call.idx not in self._work:
            self._work[call.idx] = self.cell.work(self.cell.ring[call.idx])
        return self._work[call.idx]

    def rate(self):
        """Operations completed over the whole window a second: every
        call's operations (signatures, points) over the time from the
        window's start to the end of its last call."""
        t0, t1 = self.window
        if not self.calls or t1 <= t0:
            return None
        return sum(self.cell.ring[c.idx].ops for c in self.calls) / (t1 - t0)


def stage(log, t_process: float, what: str):
    """A set-up stage's end, in seconds since process start."""
    print(f"set-up: {time.perf_counter() - t_process:8.3f} s  {what}",
          file=log, flush=True)


def _sync(on_card: bool):
    if on_card:
        import torch
        torch.cuda.synchronize()


def _loop(cell, seconds: float, first: int, phase: str, annotate: bool):
    """Calls back to back, one caller, until `seconds` have passed: the
    last call starts before the deadline and every call ends."""
    calls = []
    start = time.perf_counter()
    deadline = start + seconds
    i = first
    while True:
        idx = i % len(cell.ring)
        err = None
        t0 = time.perf_counter()
        try:
            with tracing.annotation(tracing.CALL, annotate):
                out = cell.call(cell.ring[idx])
        except Exception:                   # noqa: BLE001 - reported below
            out, err = None, traceback.format_exc()
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, idx, phase, out, err))
        i += 1
        if t1 >= deadline:
            return calls, start


def _int_rate(device):
    """The card's peak integer rate, and its name, power limit and
    maximum SM clock as `nvidia-smi` reads them."""
    import subprocess

    import torch

    import yardstick
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    line = out[index]
    clock = float(line.split(",")[-1].split()[0])
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return yardstick.int_rate(sms, clock), line, sms


def run_cell(cs: CellSpec, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, log=sys.stderr) -> dict:
    """One run; returns the result line's object, `checks` last."""
    import torch
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    stage(log, t_process, "torch and the card")
    mod = load_module(cs.entry_path)
    cell = mod.Cell(cs.config, cs.mix, seed)
    stage(log, t_process, "pool and ring")
    cell.bind(device)
    spans = None
    if trace:
        spans = tracing.Spans(mod.SPANS, on_card)
        spans.install()
    try:
        for i in range(WARMUP_CALLS):
            cell.call(cell.ring[i % len(cell.ring)])
            _sync(on_card)
            stage(log, t_process, f"warm-up call {i + 1}")
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        run = Run(cell, time.perf_counter() - t_process)
        if not trace:
            run.calls, start = _loop(cell, seconds, 0, "e2e", False)
        else:
            profiled = min(PROFILE_SECONDS, seconds / 2)
            run.calls, start = _loop(cell, seconds - profiled, 0, "spans",
                                     False)
            _sync(on_card)
            run.profiled_calls = _profiled(run, cell, spans, profiled,
                                           len(run.calls), on_card)
            run.calls += run.profiled_calls
        _sync(on_card)
        run.window = (start, run.calls[-1].t1)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    finally:
        if spans is not None:
            spans.remove()
    if spans is not None:
        run.spans = spans.resolved()
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        run.int_rate, smi, sms = _int_rate(device)
        print(f"card: {smi} (name, power limit, max SM clock), {sms} SMs",
              file=log)

    ms = sorted((c.t1 - c.t0) * 1e3 for c in run.calls)
    print(f"calls: {len(ms)}, ms min/25/50/75/max "
          + " ".join(f"{ms[int(q * (len(ms) - 1))]:.3f}"
                     for q in (0, 0.25, 0.5, 0.75, 1)), file=log)
    t_ref = time.perf_counter()
    want = cell.expected()
    mismatched, failed = 0, 0
    for c in run.calls:
        if c.error is not None:
            failed += 1
            if failed == 1:
                print(f"call {c.idx} raised:\n{c.error}", file=log)
            continue
        bad = cell.mismatches(want[c.idx], c.out)
        mismatched += bad
        failed += bad > 0
    print(f"reference: {time.perf_counter() - t_ref:.3f} s for "
          f"{len(cell.ring)} batches; {len(run.calls)} calls compared",
          file=log)

    metrics = {}
    for m in (cs.per_layer if trace else cs.end_to_end):
        reader = load_module(metric_path(m["name"]))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": failed == 0 and bool(run.calls),
              "attempted": len(run.calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        device_info["busy_s"] = tracing.busy_s(run.profile)
        device_info["window_s"] = tracing.window_s(run.profile)
        result["breakdown"] = tracing.breakdown(run.profile)
    result["checks"] = {
        mod.CHECK: {"value": mismatched, "limit": 0},
        "calls_failed": {"value": failed, "limit": 0}}
    return result


def _profiled(run, cell, spans, seconds, first, on_card):
    """The tail of a traced window under torch.profiler: one call outside
    the `bench:window` annotation, then calls inside it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    spans.annotate = True
    try:
        with profile(activities=acts) as prof:
            cell.call(cell.ring[first % len(cell.ring)])
            _sync(on_card)
            with tracing.annotation(tracing.WINDOW, True):
                calls, _ = _loop(cell, seconds, first + 1, "profile", True)
                _sync(on_card)
    finally:
        spans.annotate = False
    reading = tracing.read_profile(prof)
    if on_card:                   # a CPU run reports no device numbers
        run.profile = reading
    return calls
