"""The host expansion of a hash-to-curve call: host milliseconds inside
`h2c.expand_message_xmd_batch` (RFC 9380 expand_message_xmd, one native
SHA-256 call a stage), summed within each span-timed call, mean over
those calls."""

import spans_per_call


def read(run):
    return spans_per_call.summed_ms(run, "h2c.expand_message_xmd_batch",
                                    False)
