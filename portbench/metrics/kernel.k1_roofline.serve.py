"""K1 (pointer_step_grouped): its least time at the dispatch's shape over its time in the device trace."""

from portbench.harness import reduce

LAYER = "ops/pointer_kernel.py -> csrc/pointer_kernel.cu"
UNIT = "%"
MOVES = "solve_rate"


def read(rec):
    return reduce.roofline_pct(rec, "pointer_step_grouped")
