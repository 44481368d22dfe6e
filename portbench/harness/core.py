"""One run of one cell: the card's checks, the traffic driver, the metrics
the cell reports, the judge's numbers beside their limits, and the result
line."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

from portbench.harness import manifest, trace
from portbench.harness.cell import Cell

# top-level modules that no run may hold once its window has closed: JAX and
# the package the port was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "rl4co_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not measured (exit {out.returncode})"


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, root: str = manifest.ROOT, cfg_overrides=None,
             param_overrides=None, hooks=None):
    """Run cell ``name`` once; returns the result line (a dict) and the
    lines for standard error, the numbers compared last."""
    bench = manifest.benchmark(root)
    wl = manifest.workload(bench, name, root)
    cfg = {**manifest.config(bench, wl["config"], root), **(cfg_overrides or {})}
    program, reference = manifest.family(cfg["family"])
    cell = Cell(name=name, cfg=cfg, params={**wl["params"], **(param_overrides or {})},
                limits=wl["limits"], seed=seed, seconds=seconds, trace=traced, device=device,
                program=program, reference=reference, hooks=hooks or {})
    out = manifest.traffic(wl["kind"]).run(cell)
    setup_s = out.window_start - t_start

    metrics, extra = {}, {}
    if not traced:
        for m in manifest.end_to_end_of(bench, name):
            value = setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rec = {**(out.records or {}), "memory_peak_bytes": out.memory_peak_bytes}
        for m in manifest.per_layer_of(bench, name):
            value = manifest.metric_reader(m["name"], root).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": wl["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    if traced and out.records:
        tr = out.records["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        extra["breakdown"] = trace.breakdown(out.records.get("labelled_trace", tr))

    if set(out.checks) != set(cell.limits):
        raise RuntimeError(f"the judge read {sorted(out.checks)}, the cell limits "
                           f"{sorted(cell.limits)}")
    checks = {k: {"value": out.checks[k], "limit": cell.limits[k]} for k in sorted(cell.limits)}
    within = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": bool(within and out.failed == 0), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev, **extra,
            "checks": checks}
    marks = out.notes.pop("marks", {})
    lines = [f"{k}: {v}" for k, v in out.notes.items()]
    lines += [f"set-up: {k} done at {t - t_start:.3f} s" for k, t in marks.items()]
    lines.append(f"setup_s: {setup_s}")
    lines += [f"check {k}: {c['value']} limit {c['limit']}" for k, c in checks.items()]
    return line, lines


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import rl4co_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(rl4co_tpu_torch.__file__)))
    if where != manifest.ROOT:
        print(f"the port was imported from {where}, not from this checkout", file=sys.stderr)
        return 2
    wl = manifest.workload(manifest.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that no run may load were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for s in lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
