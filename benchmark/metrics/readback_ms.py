"""The read-back of a call: the host milliseconds of the program's
`*.readback` spans (each synchronising copy to the host, so the host's
wait for the device, and the reshaping after it), summed within each
profiled call, mean over those calls."""

import program_spans


def read(run):
    return program_spans.summed_host_ms(run, ".readback")
