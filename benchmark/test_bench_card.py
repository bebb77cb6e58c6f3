"""The controls of `correct` on the card (`python -m pytest benchmark/ -m
card` on a machine with one): on three seeds each, the program's answers
match the reference and the control's (a configuration's guarantee
broken) do not.  The verify control runs at the `verify.new_block` cell's
own size; the MSM control at 2^16 points, a sixteenth of its cell's."""

import pytest

import control
import harness
from test_bench_harness import ROOT

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def _spec(workload):
    cs = harness.load_cell(ROOT, workload)
    if workload == "msm.bip340_batch":
        cs.config["distinct_points"] = 4096
        cs.mix.update(lanes=1 << 16, ring=2)
    return cs


@pytest.mark.card
@pytest.mark.parametrize("workload", ["verify.new_block",
                                      "msm.bip340_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_on_card(card, workload, seed):
    r = control.readings(_spec(workload), seed, card)
    assert r["program"] == 0
    assert r["control"] > 0
