import time

import torch

from conftest import TINY_CFG, TINY_PARAMS
from portbench.harness.core import run_cell


def test_dispatches_are_offered_at_the_cells_rate():
    # below the entry's capacity the client waits for each dispatch's due time
    params = dict(TINY_PARAMS["pomo_cvrp50.serve_aug8"], rate=4.0)
    t0 = time.perf_counter()
    line, lines = run_cell("pomo_cvrp50.serve_aug8", 2**31 + 31, 1.0, False,
                           torch.device("cpu"), t0, cfg_overrides=TINY_CFG, param_overrides=params)
    dispatches = line["attempted"] // params["instances_per_dispatch"]
    assert 4 <= dispatches <= 6 and line["correct"]    # the offered rate, not the capacity
    # the latency is read, but the cell reports only the metrics listed for it
    p50 = float(next(s for s in lines if s.startswith("solve_ms_p50")).split(": ")[1])
    assert 0 < p50 < 250          # a dispatch answers well inside its 250 ms slot
    assert set(line["metrics"]) == {"setup_s", "solve_rate"}
