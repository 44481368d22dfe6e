"""Peak device memory of the run (torch.cuda.max_memory_allocated), before the judge."""

from portbench.harness import reduce

LAYER = "device"
UNIT = "GiB"
MOVES = "train_rate"


def read(rec):
    return reduce.peak_gib(rec)
