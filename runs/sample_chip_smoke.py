"""Where `chip_smoke.py`'s time goes: its `main` run under a stack sampler.

    python3 runs/sample_chip_smoke.py OUT.json [--root DIR] [--interval S]

A thread reads the main thread's stack every ``interval`` seconds (0.25 by
default) and counts each ``function:line`` of ``chip_smoke.py`` on it once
per sample. ``OUT.json`` maps each to its seconds, inclusive: ``main:<line>``
is the time of that line of `main`, a deeper frame the time spent under it.
The script's own output and exit code are `chip_smoke.py`'s. Processes it
starts (the data-, tensor- and expert-parallel ranks) are not sampled: their
time shows as the line that waits for them.
"""

import argparse
import collections
import json
import os
import runpy
import sys
import threading


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--interval", type=float, default=0.25)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    script = os.path.join(root, "chip_smoke.py")
    sys.path.insert(0, root)
    os.chdir(root)

    main_id = threading.get_ident()
    counts = collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(args.interval):
            frame = sys._current_frames().get(main_id)
            seen = set()
            while frame is not None:
                if frame.f_code.co_filename == script:
                    seen.add(f"{frame.f_code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
            counts.update(seen)

    threading.Thread(target=sample, daemon=True).start()
    sys.argv = [script]
    try:
        return runpy.run_path(script, run_name="chip_smoke_sampled")["main"]()
    finally:
        stop.set()
        with open(args.out, "w") as f:
            json.dump({k: n * args.interval for k, n in counts.most_common()}, f, indent=0)


if __name__ == "__main__":
    sys.exit(main())
