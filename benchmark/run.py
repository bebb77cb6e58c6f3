"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the card, the program's build where it has none, the
seeded pools and ring, warm-up) runs from process start to the first timed
call; then calls go back to back for `--seconds`.  With `--trace 1` the
window times the layers by spans, and its last two seconds run under
torch.profiler.  Every answer of the window is then checked against the
plain reference.  The last line of standard output is the result; the last
lines of standard error are the numbers compared, each with its limit.
Exits with 2, printing no result, without enough CUDA cards, and with 3
when a module of JAX or of the JAX package was imported.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cs = harness.load_cell(ROOT, args.workload)
    import torch
    harness.stage(sys.stderr, T_PROCESS, "import torch")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cs.chips:
        print(f"{args.workload} needs {cs.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cs, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
