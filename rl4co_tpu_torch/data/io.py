"""Dataset npz I/O (counterpart of `rl4co_tpu/data/io.py`).

Instance dicts (str -> [B, ...] arrays) round-trip through npz as numpy
arrays; the entry points move them to the device.
"""

from __future__ import annotations

import numpy as np


def _to_numpy(v) -> np.ndarray:
    # tensors (possibly on the card) come back to the host first
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def save_instances_npz(instances: dict, path: str) -> None:
    np.savez(path, **{k: _to_numpy(v) for k, v in instances.items()})


def load_instances_npz(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
