"""The dispatches' forward FLOPs over the timed window, against the TF32 peak."""

from portbench.harness import reduce

LAYER = "whole step"
UNIT = "%"
MOVES = "solve_rate"


def read(rec):
    return reduce.mfu_pct(rec)
