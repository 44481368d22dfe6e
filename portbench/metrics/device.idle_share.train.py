"""The share of the traced updates in which no device operation ran."""

from portbench.harness import reduce

LAYER = "device"
UNIT = "%"
MOVES = "train_rate"


def read(rec):
    return reduce.idle_pct(rec)
