#!/usr/bin/env python3
"""Run one cell of the benchmark of `rl4co_tpu_torch` once, on the machine it
is started on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``) as one JSON line,
the last of standard output, and the numbers that decide ``correct`` beside
their limits as the last lines of standard error. Without the CUDA devices
the cell asks for it prints no result and exits non-zero. Cells,
configurations and metrics are listed in `BENCHMARK.json`; `PERF.md` says
what each measures.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.harness.core import main

    sys.exit(main(sys.argv[1:], T_START))
