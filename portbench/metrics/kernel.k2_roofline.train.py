"""K2 (pointer_step_single): its least time at the batch's shape over its time in the device trace."""

from portbench.harness import reduce

LAYER = "ops/pointer_kernel.py -> csrc/pointer_kernel.cu"
UNIT = "%"
MOVES = "train_rate"


def read(rec):
    return reduce.roofline_pct(rec, "pointer_step_single")
