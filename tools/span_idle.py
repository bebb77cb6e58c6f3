"""The device's idle time inside a cell's profiled calls, by the innermost
program span the host was in, beside the cell's traced result line.

    python3 tools/span_idle.py --workload <cell> --seed <n> [--seconds 20]
        [--out <file.json>] [--chrome <dir>]

Runs the cell as `benchmark/run.py --trace 1` does (`harness.run_cell` on
cuda:0) and keeps the profiler's host annotations of the program's spans
(each span opens `torch.profiler.record_function` under its own name, on
the kernels' clock).  Each device idle gap inside a profiled call (the
harness's `bench:call`) is cut at the spans' boundaries and each piece
goes to the innermost span open over it: a stage, `<path>.call` where no
stage was open, "(no span)" where the program opened none (a program
without spans).  Prints the result line, the profiled calls' host ms
(median, quartiles) and the idle table, and writes them to `--out`.

`--chrome <dir>` then records one more call of the cell under
`profiling.trace(<dir>)` and reports, from its `trace.json`, each span
name of that call on the host's row (`user_annotation`) or missing, and
how many of the call's kernels start inside its `<path>.call` interval.
On a card (`--device cuda:0`, the default); `--device cpu` rehearses it,
where the profiler sees no device work.  Imports no JAX.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import harness  # noqa: E402
import tracing  # noqa: E402

# The program's span names: `<path>.<stage>`.
SPAN = re.compile(r"(sign|verify|schnorr|h2c|msm)\.[a-z_]+")
NO_SPAN = "(no span)"


def _program_notes(prof) -> list:
    """(name, start, end) of the program's span annotations on the host's
    row, in the profiler's microseconds."""
    from torch.autograd import DeviceType
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == DeviceType.CPU and SPAN.fullmatch(ev.name)]


def _gaps(profile: dict) -> list:
    """The device's idle intervals inside the profiled window."""
    lo, hi = profile["window"]
    out, cur = [], lo
    for s, e in tracing._union([(s, e) for _, s, e in profile["ops"]]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_by_span(profile: dict, notes: list) -> dict:
    """Seconds of device idle time inside the profiled calls by the
    innermost program span over it."""
    calls = [(s, e) for name, s, e in profile["notes"] if name == "call"]
    gaps = _gaps(profile)
    ends = [g1 for _, g1 in gaps]
    out = {}
    for c0, c1 in calls:
        inside = [n for n in notes if c0 <= n[1] and n[2] <= c1]
        cuts = sorted({c0, c1} | {t for _, s, e in inside for t in (s, e)})
        for g0, g1 in gaps[bisect.bisect_left(ends, c0):]:
            if g0 >= c1:
                break
            a, b = max(g0, c0), min(g1, c1)
            if b <= a:
                continue
            edges = [a] + [t for t in cuts if a < t < b] + [b]
            for s, e in zip(edges, edges[1:]):
                mid = (s + e) / 2
                over = [n for n in inside if n[1] <= mid <= n[2]]
                name = max(over, key=lambda n: (n[1], -n[2]))[0] \
                    if over else NO_SPAN
                out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def chrome_check(cell, log_dir: str) -> dict:
    """One call under `profiling.trace(log_dir)`: its span names on the
    host's row of the Chrome trace, and its kernels inside the root."""
    import torch

    from secp256k1_tpu_torch.utils import profiling
    with profiling.trace(log_dir):
        cell.call(cell.ring[0])
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    names = {r.name for r in profiling.spans()}
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as fh:
        events = [ev for ev in json.load(fh)["traceEvents"]
                  if ev.get("ph") == "X"]
    host = {ev["name"] for ev in events
            if ev.get("cat") == "user_annotation" and ev["name"] in names}
    roots = [ev for ev in events if ev.get("cat") == "user_annotation"
             and ev["name"].endswith(".call") and ev["name"] in names]
    kernels = [ev["ts"] for ev in events if ev.get("cat") == "kernel"]
    inside = sum(any(r["ts"] <= t <= r["ts"] + r["dur"] for r in roots)
                 for t in kernels)
    return {"spans": sorted(names), "on_host_row": sorted(host),
            "missing": sorted(names - host), "kernels": len(kernels),
            "kernels_inside_root": inside}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    ap.add_argument("--chrome")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    kept = {"notes": []}
    read_profile, profiled = tracing.read_profile, harness._profiled

    def reading(prof):
        kept["notes"] = _program_notes(prof)
        kept["profile"] = read_profile(prof)
        return kept["profile"]

    def profiled_kept(run, cell, *rest):
        kept["cell"] = cell
        kept["calls"] = profiled(run, cell, *rest)
        return kept["calls"]
    tracing.read_profile, harness._profiled = reading, profiled_kept

    cs = harness.load_cell(ROOT, args.workload)
    result = harness.run_cell(cs, args.seed, args.seconds, True,
                              args.device, T_PROCESS)
    ms = [(c.t1 - c.t0) * 1e3 for c in kept["calls"]]
    idle = idle_by_span(kept["profile"], kept["notes"])
    report = {"workload": args.workload, "seed": args.seed,
              "result": result, "profiled_calls": len(ms),
              "profiled_call_ms": statistics.quantiles(ms, n=4)
              if len(ms) > 1 else ms * 3,
              "idle_in_calls_s": dict(sorted(idle.items(),
                                             key=lambda kv: -kv[1])),
              "idle_in_calls_total_s": sum(idle.values())}
    if args.chrome:
        report["chrome"] = chrome_check(kept["cell"], args.chrome)
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
