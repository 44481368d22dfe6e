"""Solomon CVRPTW benchmark instances (counterpart of `rl4co_tpu/data/solomon.py`).

Parses the classic Solomon text format (VEHICLE / CUSTOMER sections) into
the CVRPTW instance dict. ``normalize_demand=True`` divides demands by the
vehicle capacity (the env's convention).
"""

from __future__ import annotations

import numpy as np
import torch


def load_solomon_instance(path: str, normalize_demand: bool = True) -> dict:
    """One Solomon file -> numpy arrays: ``locs [N, 2]``, ``depot [2]``,
    ``demand [N]``, ``time_windows [N+1, 2]`` and ``durations [N+1]`` (the
    depot first), and ``capacity``."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f]

    capacity = None
    rows = []
    section = None
    for ln in lines:
        token = ln.strip().upper()
        if token.startswith("VEHICLE"):
            section = "vehicle"
            continue
        if token.startswith("CUSTOMER"):
            section = "customer"
            continue
        parts = ln.split()
        if section == "vehicle" and len(parts) == 2 and parts[0].isdigit():
            capacity = float(parts[1])
        elif section == "customer" and len(parts) == 7 and parts[0].isdigit():
            rows.append([float(x) for x in parts])

    if capacity is None or not rows:
        raise ValueError(f"Malformed Solomon file: {path}")
    arr = np.asarray(rows)  # cols: id, x, y, demand, ready, due, service
    depot, cust = arr[0], arr[1:]
    demand = cust[:, 3]
    if normalize_demand:
        demand = demand / capacity
    time_windows = np.stack(
        [np.concatenate([[depot[4]], cust[:, 4]]),
         np.concatenate([[depot[5]], cust[:, 5]])],
        axis=-1,
    )
    durations = np.concatenate([[depot[6]], cust[:, 6]])
    return {
        "locs": cust[:, 1:3].astype(np.float32),
        "depot": depot[1:3].astype(np.float32),
        "demand": demand.astype(np.float32),
        "time_windows": time_windows.astype(np.float32),
        "durations": durations.astype(np.float32),
        "capacity": np.float32(capacity),
    }


def solomon_to_env_batch(instance: dict, scale: bool = True):
    """A loaded Solomon instance -> (CVRPTW env, a batch of one as CPU
    tensors). Coordinates, durations and windows are divided by the horizon
    (the depot's due date) when ``scale``; demands are already normalized by
    the loader."""
    from rl4co_tpu_torch.envs.routing.cvrptw import CVRPTW

    horizon = float(instance["time_windows"][0, 1])
    n = instance["locs"].shape[0]
    env = CVRPTW(num_loc=n, vehicle_capacity=1.0, max_time=horizon, scale=scale)
    s = horizon if scale else 1.0
    batch = {
        "locs": torch.as_tensor(instance["locs"])[None] / s,
        "depot": torch.as_tensor(instance["depot"])[None] / s,
        "demand": torch.as_tensor(instance["demand"])[None],
        "durations": torch.as_tensor(instance["durations"])[None] / s,
        "time_windows": torch.as_tensor(instance["time_windows"])[None] / s,
    }
    return env, batch
