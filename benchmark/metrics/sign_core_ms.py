"""The sign core of a signing call: CUDA events around `_sign_e2e_core`
(k * G by #6, the inversions, r and s) to completion, summed over the
call's rounds, mean over the span-timed calls."""

import spans_per_call


def read(run):
    return spans_per_call.summed_ms(run, "ecdsa._sign_e2e_core", True)
