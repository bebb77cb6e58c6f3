"""How the device cores of the profiled calls ran: the share of the
program's `*.core` spans that carry `how` (captured, replayed or eager)
that replayed a CUDA graph."""

import program_spans


def read(run):
    return program_spans.share_pct(run, ".core", "how", "replayed")
