"""The control of each cell's `correct`, at the cell's own size on the
card: for every seed, every batch of the ring through the program and
through the cell's control (a guarantee of the configuration broken), each
counted against the plain reference.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "batches", "program", "control"},
the last two the numbers the check compares (the program's must be 0, the
control's must not).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402


def readings(cs, seed: int, device: str) -> dict:
    mod = harness.load_module(cs.entry_path)
    cell = mod.Cell(cs.config, cs.mix, seed)
    cell.bind(device)
    want = cell.expected()
    prog = sum(cell.mismatches(w, cell.call(b))
               for w, b in zip(want, cell.ring))
    ctrl = sum(cell.mismatches(w, cell.control(b))
               for w, b in zip(want, cell.ring))
    return {"seed": seed, "batches": len(cell.ring), "check": mod.CHECK,
            "program": prog, "control": ctrl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cs = harness.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cs, seed, "cuda:0")
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
