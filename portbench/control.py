#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 5

One JSON line per reading. For each of ``--seeds``, the program's numbers
from a run of the cell with a window of ``--seconds`` (the lower readings).
For each of ``--control-seeds``, the numbers of the control: the plain
reference put in the program's place with its matrix products in TF32, the
nearest precision below the configurations' float32 with TF32 off (the upper
readings); for a training cell also those of a planted fault, the reference
taking its loss's mean over half the batch. Benchmark runs do not run this.
"""

import sys
import time


def serve_control(cell_name, seed, seconds, device):
    from portbench.harness.core import run_cell
    from portbench.traffic.serve_dispatch import reference_serve

    def control(cell, weights):
        return reference_serve(cell, weights, lower=True)

    line, _ = run_cell(cell_name, seed, seconds, False, device, time.perf_counter(),
                       hooks={"serve": control})
    return {"control": {k: c["value"] for k, c in line["checks"].items()}}


def train_control(cell_name, seed, device):
    from portbench.harness import manifest
    from portbench.harness.cell import Cell
    from portbench.traffic import train_update as tu
    from portbench.traffic.serve_dispatch import tf32

    bench = manifest.benchmark()
    wl = manifest.workload(bench, cell_name)
    cfg = manifest.config(bench, wl["config"])
    program, reference = manifest.family(cfg["family"])
    cell = Cell(name=cell_name, cfg=cfg, params=wl["params"], limits=wl["limits"], seed=seed,
                seconds=0, trace=False, device=device, program=program, reference=reference)
    weights, batches, sampling = tu.make_inputs(cell)
    start = sampling.get_state()
    checked = batches[:cell.params["checked_steps"]]

    def steps(**kw):
        sampling.set_state(start)
        return tu.ref_steps(cell, weights, checked, sampling, **kw)

    def judged(got):
        want = steps(follow=got)
        return {**tu.judge(got, want), "sample_mismatch_by_update": want["sample_mismatch"]}

    with tf32(True):
        low = steps()
    half = steps(loss_rows=cell.params["batch"] // 2)
    return {"control": judged(low), "half_batch": judged(half)}


def main(argv):
    import argparse
    import json

    import torch

    from portbench.harness import manifest
    from portbench.harness.core import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = manifest.workload(manifest.benchmark(), args.workload)["kind"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        line, _ = run_cell(args.workload, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"seed": seed, "program": {k: c["value"] for k, c in line["checks"].items()},
                          "correct": line["correct"], "failed": line["failed"]}), flush=True)
    for seed in controls:
        got = (serve_control(args.workload, seed, args.seconds, device) if kind == "serve_dispatch"
               else train_control(args.workload, seed, device))
        print(json.dumps({"seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
