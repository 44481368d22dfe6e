"""The updates' FLOPs (the sampled rollout x3, the baseline's x1) over the timed window, against the TF32 peak."""

from portbench.harness import reduce

LAYER = "whole step"
UNIT = "%"
MOVES = "train_rate"


def read(rec):
    return reduce.mfu_pct(rec)
