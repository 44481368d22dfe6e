"""What the harness hands a traffic driver, and what the driver hands back."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict                 # the configuration file
    params: dict              # the cell's traffic parameters
    limits: dict              # {number compared: its limit}
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    program: Any              # portbench/programs/<family>.py
    reference: Any            # portbench/reference/<family>.py
    # stand-ins for the program's timed call, for the control and the planted
    # faults: ``serve``: ``(cell, weights) -> serve function``; ``update``:
    # ``(algo, instances) -> metrics``
    hooks: dict = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def expect_kernel(self, kernel: str, before: int) -> None:
        """Fail unless the port launched ``kernel`` since the count ``before``
        (on the card only: on the CPU the port computes the plain version)."""
        if self.device.type != "cuda":
            return
        if self.program.kernel_launches()[kernel] <= before:
            raise RuntimeError(f"{kernel} did not launch: the timed path is not the kernel path")

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))


@dataclasses.dataclass
class Outcome:
    window_start: float       # time.perf_counter() when the window opened
    e2e: dict                 # {end-to-end metric: value}
    attempted: int
    failed: int
    checks: dict              # {number compared: value}
    memory_peak_bytes: int
    records: Optional[dict] = None   # what the per-layer readers read (traced runs)
    notes: dict = dataclasses.field(default_factory=dict)  # printed on stderr
