"""Per-layer readings from a traced run's records. A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.harness import counts


def roofline_pct(rec: dict, kernel: str) -> Optional[float]:
    """The kernel's least time at its shape (`counts.pointer_step_least_s`),
    summed over its launches in the traced stretch, over its summed time in
    the device trace, in %."""
    shape = rec.get("kernel_shapes", {}).get(kernel)
    times = [e - s for name, s, e in rec["trace"].device if kernel in name] if "trace" in rec else []
    if shape is None or not times or sum(times) <= 0:
        return None
    return 100.0 * len(times) * counts.pointer_step_least_s(*shape) / (sum(times) / 1e6)


def idle_pct(rec: dict) -> Optional[float]:
    """One minus the union of the device's operations over the stretch, in %."""
    tr = rec.get("trace")
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def launches_per_step(rec: dict) -> Optional[float]:
    """Device operations in the stretch over its decode steps."""
    tr = rec.get("trace")
    if tr is None or not tr.device or not rec.get("decode_steps"):
        return None
    return len(tr.device) / rec["decode_steps"]


def peak_gib(rec: dict) -> Optional[float]:
    peak = rec.get("memory_peak_bytes")
    return peak / 2**30 if peak else None


def mfu_pct(rec: dict) -> Optional[float]:
    """The configuration's forward FLOPs over the timed window (x3 for the
    rollout that is trained), over its seconds and the TF32 peak, in %."""
    if not rec.get("model_flops") or not rec.get("model_flops_s"):
        return None
    return 100.0 * rec["model_flops"] / rec["model_flops_s"] / counts.TF32_FLOPS
