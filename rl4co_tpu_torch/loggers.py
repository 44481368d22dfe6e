"""Experiment loggers (counterpart of `rl4co_tpu/loggers.py`): callables that
take the trainer's metric dicts. Only the JSONL file and the fan-out are
ported; the CSV, TensorBoard, MLflow, W&B, Neptune, Comet and Aim back ends
wait in ROADMAP.md (item 15).
"""

from __future__ import annotations

import json
import os
import time


class JSONLLogger:
    """One JSON object per record, appended to ``path``: ``"t"`` (seconds since
    the logger was made, to the millisecond), then every metric as a float, or
    as a string where it is none (an env's name)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def __call__(self, metrics: dict) -> None:
        record = {"t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class MultiLogger:
    """Every record to each of ``loggers``; `finalize` reaches those that have
    a ``finalize`` or ``close``."""

    def __init__(self, *loggers):
        self.loggers = loggers

    def __call__(self, metrics: dict) -> None:
        for lg in self.loggers:
            lg(metrics)

    def finalize(self) -> None:
        for lg in self.loggers:
            fin = getattr(lg, "finalize", None) or getattr(lg, "close", None)
            if callable(fin):
                fin()
