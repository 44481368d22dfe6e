"""Dataset npz I/O (counterpart of `rl4co_tpu/data/io.py`).

Instance dicts (str -> [B, ...] arrays) round-trip through npz as numpy
arrays; the entry points move them to the device. `load_reference_npz` reads
the reference's generated datasets (the committed `data/*/test*_seed1234.npz`)
into this package's instance conventions.
"""

from __future__ import annotations

import numpy as np


def to_numpy(v) -> np.ndarray:
    """An array or a tensor (possibly on the card, brought to the host) as numpy."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def save_instances_npz(instances: dict, path: str) -> None:
    np.savez(path, **{k: to_numpy(v) for k, v in instances.items()})


def load_instances_npz(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# envs whose reference files hold fixed keys: only those are kept
_REFERENCE_KEYS = {
    "op": ("locs", "depot", "prize", "max_length"),
    "pctsp": ("locs", "depot", "penalty", "deterministic_prize", "stochastic_prize"),
    "spctsp": ("locs", "depot", "penalty", "deterministic_prize", "stochastic_prize"),
}


def load_reference_npz(path: str, env_name: str) -> dict:
    """Load a dataset generated by the reference, in this package's
    conventions (float32; CVRP demands normalized by capacity).

    A CVRP/SDVRP file in the reference's format holds integer demands and a
    per-instance ``capacity``: demands are divided by it. A file whose demands
    are at most 1 is taken as already normalized and passed as it is. Demands
    above 1 with no ``capacity`` key raise a ValueError, a deliberate
    difference: the JAX loader passes them on unnormalized, and against a
    vehicle capacity of 1 no customer with a demand above 1 can be served.
    OP and PCTSP/SPCTSP files keep the reference's keys alone; a missing one
    raises KeyError, as the JAX loader does."""
    raw = load_instances_npz(path)
    if env_name in ("cvrp", "sdvrp"):
        demand = raw["demand"].astype(np.float32)
        if demand.max() > 1.0:
            if "capacity" not in raw:
                raise ValueError(
                    f"{path}: demands up to {demand.max()} and no 'capacity' key; "
                    "integer demands need the capacity to be normalized by")
            demand = demand / raw["capacity"].astype(np.float32)[:, None]
        return {
            "locs": raw["locs"].astype(np.float32),
            "depot": raw["depot"].astype(np.float32),
            "demand": demand,
        }
    # the reference's keys alone, as float32; a missing key raises KeyError
    keys = _REFERENCE_KEYS.get(env_name)
    if keys is not None:
        return {k: raw[k].astype(np.float32) for k in keys}
    # every other env: floats as float32, the rest as stored
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v for k, v in raw.items()}
