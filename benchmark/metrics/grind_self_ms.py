"""The signer's own work between its stages: the self time of the
program's `sign.round` spans (each round's host milliseconds less its
planes, core and read-back: the lanes picked, their rows gathered and
scattered back), summed within each profiled call, mean over those
calls."""

import program_spans


def read(run):
    return program_spans.self_ms(run, "sign.round")
