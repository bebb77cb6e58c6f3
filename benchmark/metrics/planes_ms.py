"""Host marshalling of a call: the host milliseconds of the program's
`*.planes` spans (rows made ready and uploaded: `sign.planes`,
`verify.planes`, `schnorr.planes`, `h2c.planes`), summed within each
profiled call, mean over those calls."""

import program_spans


def read(run):
    return program_spans.summed_host_ms(run, ".planes")
