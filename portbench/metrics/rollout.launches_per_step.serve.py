"""Device operations per decode step of a dispatch."""

from portbench.harness import reduce

LAYER = "models/policies/constructive.py"
UNIT = "launches/step"
MOVES = "solve_rate"


def read(rec):
    return reduce.launches_per_step(rec)
