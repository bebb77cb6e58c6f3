"""Process start to the first timed call: imports, the card, the
program's build where it has none, the pools and ring, the warm-up."""


def read(run):
    return run.setup_s
