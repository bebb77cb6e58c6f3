"""The BIP-0340 challenge hash of a Taproot verify call: host
milliseconds inside `native.tagged_hash_batch`, summed within each
span-timed call, mean over those calls."""

import spans_per_call


def read(run):
    return spans_per_call.summed_ms(run, "native.tagged_hash_batch", False)
