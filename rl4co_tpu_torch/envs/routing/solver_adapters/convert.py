"""Instance conversion helpers shared by the classical-solver adapters.

Counterpart of `rl4co_tpu/envs/routing/solver_adapters/convert.py`; reference
equivalents: `mtvrp/baselines/utils.py` (`process_instance`, `scale`) and
`constants.py` (per-solver integer scaling factors). MTVRP instances are flat
dicts of tensors (`rl4co_tpu_torch/envs/routing/mtvrp.py::generate`) or numpy
arrays; they are copied to the host and converted in numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# Integer scaling: classical solvers want integral data
# (reference `baselines/constants.py`).
PYVRP_SCALING_FACTOR = 1_000
LKH_SCALING_FACTOR = 100_000
ORTOOLS_SCALING_FACTOR = 100_000

INT32_MAX = np.iinfo(np.int32).max


def split_batch(instances) -> list[dict]:
    """Batched instance dict -> list of per-instance host dicts with derived
    fields.

    Adds ``cost_matrix`` (Euclidean, zero diagonal) and defaults
    ``vehicle_capacity`` / ``backhaul_class`` / ``open_route`` /
    ``distance_limit`` when absent (reference `utils.py::process_instance`).
    """
    inst = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in dict(instances).items()}
    b = inst["locs"].shape[0]
    out = []
    for i in range(b):
        one: dict[str, Any] = {
            k: (v[i] if v.ndim > 0 and v.shape[0] == b else v)
            for k, v in inst.items()
        }
        locs = one["locs"]
        d = np.linalg.norm(locs[:, None, :] - locs[None, :, :], axis=-1)
        np.fill_diagonal(d, 0.0)
        one["cost_matrix"] = d
        one.setdefault("vehicle_capacity", np.float64(1.0))
        one.setdefault("backhaul_class", np.int64(1))
        one.setdefault("open_route", np.bool_(False))
        one.setdefault("distance_limit", np.float64(np.inf))
        n = locs.shape[0]
        one.setdefault("time_windows",
                       np.stack([np.zeros(n), np.full(n, np.inf)], axis=-1))
        one.setdefault("service_time", np.zeros(n))
        if "demand_linehaul" not in one and "demand" in one:
            # plain CVRP instances: demand has no depot row
            dem = np.concatenate([[0.0], np.asarray(one["demand"])])
            one["demand_linehaul"] = dem
            one["demand_backhaul"] = np.zeros_like(dem)
        out.append(one)
    return out


def scale_int(x, factor: int):
    """Round scaled values to python ints; +inf maps to INT32_MAX
    (reference `utils.py::scale`)."""
    arr = np.asarray(x, dtype=np.float64) * factor
    arr = np.where(np.isinf(arr), INT32_MAX, np.round(arr))
    arr = arr.astype(np.int64)
    if arr.ndim == 0:
        return int(arr)
    return arr


def routes_to_action(routes) -> list[int]:
    """Route lists -> giant-tour action (0-separated customer indices),
    the env's action encoding (reference `pyvrp.py::solution2action`)."""
    action: list[int] = []
    for route in routes:
        action.extend(int(v) for v in route)
        action.append(0)
    return action
