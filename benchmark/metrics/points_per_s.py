"""MSM points summed over the whole window, per second of it."""


def read(run):
    return run.rate()
