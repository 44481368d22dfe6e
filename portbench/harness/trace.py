"""Reading a traced stretch: the device's operations, the host's ranges, the
union of the device's busy time, and the idle gaps labelled by what the host
was doing.

`record` reads the profiler's raw records as they are (a frozen copy of
`chip_smoke.device_events`' reader): `prof.events()` first builds a Python
tree of every event, which costs minutes over some 10^5 launches. Recording
the host's operators slows the host about twofold, so the device's busy and
idle time is read from a stretch that records the device alone, and the
idle gaps' labels from another that records both.
"""

from __future__ import annotations

import bisect
import dataclasses
import time


@dataclasses.dataclass
class Trace:
    """One profiled stretch, in the profiler's microseconds."""

    device: list      # (name, start, end) of every device operation
    host: list        # (name, start, end) of the host's ranges and operators
    window: tuple     # (start, end) of the stretch

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.device], *self.window) / 1e6


def record(fn, host: bool):
    """Run ``fn`` under `torch.profiler`, the device traced and, with
    ``host``, the host's operators too; returns ``(fn(), Trace)``. The
    stretch runs from a synchronise before ``fn`` to one after it, on the
    host's clock (the profiler's records are on it too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        result = fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    raw = prof.profiler.kineto_results
    origin = raw.trace_start_ns()
    skip = ("[memory]", "[OutOfMemory]")
    names, device, hosts = {}, [], []
    for e in raw.events():
        name = e.name()
        if name in skip or (hasattr(e, "is_hidden_event") and e.is_hidden_event()):
            continue
        if name not in names:
            names[name] = torch._C._demangle(name)
        name = names[name]
        start, end = (e.start_ns() - origin) / 1e3, (e.end_ns() - origin) / 1e3
        if e.device_type() == DeviceType.CUDA:
            # an annotated range's row on the device repeats its kernels' time
            if not (e.is_user_annotation() or name.startswith("Optimizer.")):
                device.append((name, start, end))
        else:
            hosts.append((name, start, end))
    window = ((t0 - origin) / 1e3, (t1 - origin) / 1e3)
    return result, Trace(device=device, host=hosts, window=window)


def _merged(intervals, lo, hi):
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, at = [], lo
    for s, e in _merged(intervals, lo, hi):
        if s > at:
            gaps.append((at, s))
        at = e
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _host_label(starts, host, t, reach=4000):
    """The innermost host operator open at ``t`` (the latest-starting one
    that has not ended); the runtime's own calls (``cuda*``) are passed over."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        name, s, e = host[j]
        if e > t and not name.startswith("cuda"):
            return name
    return "between host operators"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time, summed by
    name; ``idle_gaps``: the device's idle time inside the stretch, summed
    by the host operator open when each gap began. Seconds, largest first."""
    by_op = {}
    for name, s, e in tr.device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    host = sorted(tr.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    by_gap = {}
    for g0, g1 in idle_gaps([(s, e) for _, s, e in tr.device], *tr.window):
        label = _host_label(starts, host, g0)
        by_gap[label] = by_gap.get(label, 0.0) + (g1 - g0) / 1e6

    def largest(d):
        return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": largest(by_op), "idle_gaps": largest(by_gap)}
