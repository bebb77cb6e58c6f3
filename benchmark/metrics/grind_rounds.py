"""Rounds a signing call ran (round 0 included), as the program counts
them, mean over the calls of the window that report them."""


def read(run):
    vals = [getattr(c.out, "rounds", None) for c in run.calls]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
