"""Device operations of an update per decode step of its two rollouts."""

from portbench.harness import reduce

LAYER = "models/policies/constructive.py"
UNIT = "launches/step"
MOVES = "train_rate"


def read(rec):
    return reduce.launches_per_step(rec)
