"""TSPLIB95 / CVRPLIB instance and solution parsers and env adapters
(counterpart of `rl4co_tpu/data/tsplib.py`), with no third-party parser:

- :func:`read_tsplib` — TSPLIB95 problem files (``.tsp``, ``.atsp``,
  ``.vrp``): ``EUC_2D``/``CEIL_2D``/``ATT``/``GEO``/``MAN_2D``/``MAX_2D``
  node-coordinate metrics and ``EXPLICIT`` edge-weight matrices
  (``FULL_MATRIX``, ``UPPER_ROW``, ``LOWER_ROW``, ``UPPER_DIAG_ROW``,
  ``LOWER_DIAG_ROW``), plus ``DEMAND_SECTION``/``DEPOT_SECTION``/
  ``CAPACITY`` for CVRP instances.
- :func:`read_tsplib_tour` — ``.tour`` / ``.opt.tour`` solution files.
- :func:`read_cvrplib_solution` — CVRPLIB ``.sol`` route lists.
- :func:`tour_cost` — the *canonical* TSPLIB objective (per-edge integer
  rounding rules from the TSPLIB FAQ), so gaps against best-known solutions
  use the official arithmetic.
- :func:`tsplib_to_tsp_batch` / :func:`vrplib_to_cvrp_batch` — min-max
  coordinate normalization to the unit square and conversion into this
  framework's env instance batches (semantics of the reference notebooks'
  ``tsplib_to_td`` / ``vrplib_to_td``).

Everything is numpy on the host; the two adapters alone return tensors, on
the device they are given (``"cuda"`` by default, as every entry point).
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = [
    "read_tsplib",
    "read_tsplib_tour",
    "read_cvrplib_solution",
    "tsplib_distance_matrix",
    "tour_cost",
    "normalize_coords",
    "tsplib_to_tsp_batch",
    "vrplib_to_cvrp_batch",
]

_KEYWORDS = {
    "NAME", "TYPE", "COMMENT", "DIMENSION", "CAPACITY", "EDGE_WEIGHT_TYPE",
    "EDGE_WEIGHT_FORMAT", "EDGE_DATA_FORMAT", "NODE_COORD_TYPE",
    "DISPLAY_DATA_TYPE", "VEHICLES", "DISTANCE", "SERVICE_TIME",
}
_SECTIONS = {
    "NODE_COORD_SECTION", "DEPOT_SECTION", "DEMAND_SECTION",
    "EDGE_DATA_SECTION", "FIXED_EDGES_SECTION", "DISPLAY_DATA_SECTION",
    "TOUR_SECTION", "EDGE_WEIGHT_SECTION", "EOF",
}


def _tokenize(text: str):
    """Split a TSPLIB file into (keyword, value) specs and section bodies."""
    specs: dict[str, str] = {}
    sections: dict[str, list[str]] = {}
    current: list[str] | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        head = line.split(":")[0].strip().upper()
        word = line.split()[0].upper().rstrip(":")
        if head in _KEYWORDS and ":" in line:
            specs[head] = line.split(":", 1)[1].strip()
            current = None
        elif word in _SECTIONS:
            if word == "EOF":
                break
            current = sections.setdefault(word, [])
            # values may share the section header line (rare but legal)
            rest = line[len(word):].strip(" :")
            if rest:
                current.append(rest)
        elif current is not None:
            current.append(line)
        # else: free-form junk between specs — ignored
    return specs, sections


def read_tsplib(path_or_text: str) -> dict:
    """Parse a TSPLIB95 problem file (path or raw text) into a plain dict.

    Returns keys: ``name, type, dimension, edge_weight_type,
    edge_weight_format, node_coords [N,2] | None, edge_weights [N,N] | None,
    demand [N] | None, capacity | None, depot (0-based int)``.
    """
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    specs, sections = _tokenize(text)

    n = int(specs["DIMENSION"])
    out: dict = {
        "name": specs.get("NAME", ""),
        "type": specs.get("TYPE", "TSP").upper(),
        "dimension": n,
        "edge_weight_type": specs.get("EDGE_WEIGHT_TYPE", "EUC_2D").upper(),
        "edge_weight_format": specs.get("EDGE_WEIGHT_FORMAT", "").upper(),
        "capacity": float(specs["CAPACITY"]) if "CAPACITY" in specs else None,
        "node_coords": None,
        "edge_weights": None,
        "demand": None,
        "depot": 0,
    }

    if "NODE_COORD_SECTION" in sections:
        coords = np.full((n, 2), np.nan, dtype=np.float64)
        for line in sections["NODE_COORD_SECTION"]:
            parts = line.split()
            idx = int(float(parts[0])) - 1
            coords[idx] = [float(parts[1]), float(parts[2])]
        assert not np.isnan(coords).any(), "missing node coordinates"
        out["node_coords"] = coords

    if "EDGE_WEIGHT_SECTION" in sections:
        vals = [float(v) for line in sections["EDGE_WEIGHT_SECTION"]
                for v in line.split()]
        out["edge_weights"] = _expand_matrix(
            np.asarray(vals), n, out["edge_weight_format"] or "FULL_MATRIX"
        )

    if "DEMAND_SECTION" in sections:
        demand = np.zeros(n, dtype=np.float64)
        for line in sections["DEMAND_SECTION"]:
            parts = line.split()
            demand[int(float(parts[0])) - 1] = float(parts[1])
        out["demand"] = demand

    if "DEPOT_SECTION" in sections:
        ids = [int(float(v)) for line in sections["DEPOT_SECTION"]
               for v in line.split()]
        ids = [i for i in ids if i != -1]
        if ids:
            out["depot"] = ids[0] - 1
    return out


def _expand_matrix(vals: np.ndarray, n: int, fmt: str) -> np.ndarray:
    m = np.zeros((n, n), dtype=np.float64)
    fmt = fmt.upper()
    if fmt == "FULL_MATRIX":
        m = vals.reshape(n, n)
    elif fmt in ("UPPER_ROW", "LOWER_COL"):
        iu = np.triu_indices(n, k=1)
        m[iu] = vals
        m = m + m.T
    elif fmt in ("LOWER_ROW", "UPPER_COL"):
        il = np.tril_indices(n, k=-1)
        m[il] = vals
        m = m + m.T
    elif fmt in ("UPPER_DIAG_ROW", "LOWER_DIAG_COL"):
        iu = np.triu_indices(n, k=0)
        m[iu] = vals
        m = m + np.triu(m, k=1).T
    elif fmt in ("LOWER_DIAG_ROW", "UPPER_DIAG_COL"):
        il = np.tril_indices(n, k=0)
        m[il] = vals
        m = m + np.tril(m, k=-1).T
    else:
        raise ValueError(f"Unsupported EDGE_WEIGHT_FORMAT: {fmt}")
    return m


def read_tsplib_tour(path_or_text: str) -> np.ndarray:
    """Parse a TSPLIB ``.tour``/``.opt.tour`` file; returns a 0-based tour."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    _, sections = _tokenize(text)
    tour = []
    for line in sections.get("TOUR_SECTION", []):
        for v in line.split():
            i = int(float(v))
            if i == -1:
                break
            tour.append(i - 1)
    assert tour, "no TOUR_SECTION found"
    return np.asarray(tour, dtype=np.int64)


def read_cvrplib_solution(path_or_text: str) -> dict:
    """Parse a CVRPLIB ``.sol`` file: ``Route #k: i j ...`` lines + ``Cost``.

    Route node ids are 1-based customer indices (vrplib convention);
    returned routes are 1-based node ids into the instance (customer c ->
    node c, depot 0 excluded), matching ``vrplib.read_solution``.
    """
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    routes, cost = [], None
    for line in text.splitlines():
        line = line.strip()
        low = line.lower()
        if low.startswith("route"):
            body = line.split(":", 1)[1]
            routes.append([int(v) for v in body.split()])
        elif low.startswith("cost"):
            cost = float(line.split()[-1])
    return {"routes": routes, "cost": cost}


# ---------------------------------------------------------------------------
# Canonical TSPLIB distances (TSPLIB95 spec §2.1 / FAQ)
# ---------------------------------------------------------------------------

def _nint(x: np.ndarray) -> np.ndarray:
    return np.floor(x + 0.5)


def _geo_radians(coords: np.ndarray) -> np.ndarray:
    # Canonical GEO arithmetic (TSPLIB FAQ / Concorde): the degree part is
    # TRUNCATED toward zero (deg = (int) x), not nearest-int rounded —
    # trunc keeps sign-correctness for negative longitudes (ulysses16's
    # optimal tour costs 6859).
    deg = np.trunc(coords)
    minutes = coords - deg
    return math.pi * (deg + 5.0 * minutes / 3.0) / 180.0


def tsplib_distance_matrix(problem: dict) -> np.ndarray:
    """Full [N, N] matrix under the instance's canonical metric."""
    ewt = problem["edge_weight_type"]
    if ewt == "EXPLICIT":
        assert problem["edge_weights"] is not None
        return problem["edge_weights"]
    coords = problem["node_coords"]
    assert coords is not None, f"no coordinates for {ewt}"
    if ewt == "GEO":
        rad = _geo_radians(coords)
        lat, lon = rad[:, 0], rad[:, 1]
        rrr = 6378.388
        q1 = np.cos(lon[:, None] - lon[None, :])
        q2 = np.cos(lat[:, None] - lat[None, :])
        q3 = np.cos(lat[:, None] + lat[None, :])
        d = rrr * np.arccos(
            np.clip(0.5 * ((1.0 + q1) * q2 - (1.0 - q1) * q3), -1.0, 1.0)
        ) + 1.0
        d = np.floor(d)
        np.fill_diagonal(d, 0.0)
        return d
    diff = coords[:, None, :] - coords[None, :, :]
    if ewt == "MAN_2D":
        return _nint(np.abs(diff).sum(-1))
    if ewt == "MAX_2D":
        return _nint(np.abs(diff)).max(-1)
    euc = np.sqrt((diff ** 2).sum(-1))
    if ewt == "EUC_2D":
        return _nint(euc)
    if ewt == "CEIL_2D":
        return np.ceil(euc)
    if ewt == "ATT":
        r = np.sqrt((diff ** 2).sum(-1) / 10.0)
        t = _nint(r)
        return np.where(t < r, t + 1.0, t)
    raise ValueError(f"Unsupported EDGE_WEIGHT_TYPE: {ewt}")


def tour_cost(problem: dict, tour: np.ndarray, rounded: bool = True) -> float:
    """Closed-tour cost. ``rounded=True`` uses the canonical TSPLIB metric
    (what best-known-solution values are stated in); ``rounded=False`` gives
    the plain Euclidean length (what the env reward measures)."""
    tour = np.asarray(tour)
    if rounded:
        dm = tsplib_distance_matrix(problem)
        return float(dm[tour, np.roll(tour, -1)].sum())
    coords = problem["node_coords"]
    if coords is None:
        raise ValueError(
            "tour_cost(rounded=False) needs NODE_COORD_SECTION coordinates; "
            f"this instance is EDGE_WEIGHT_TYPE={problem['edge_weight_type']} "
            "with no coordinates — use rounded=True (distance-matrix metric)."
        )
    seq = coords[tour]
    return float(np.linalg.norm(seq - np.roll(seq, -1, axis=0), axis=1).sum())


# ---------------------------------------------------------------------------
# Env adapters (reference notebook `tsplib_to_td` / `vrplib_to_td` semantics)
# ---------------------------------------------------------------------------

def normalize_coords(coords: np.ndarray) -> np.ndarray:
    """Per-axis min-max scale into the unit square (reference notebooks'
    ``normalize_coord``)."""
    lo = coords.min(axis=0)
    span = coords.max(axis=0) - lo
    span = np.where(span <= 0, 1.0, span)
    return (coords - lo) / span


def tsplib_to_tsp_batch(problem: dict, normalize: bool = True, device="cuda"):
    """TSPLIB problem -> (TSP env sized to the instance, batch of one on
    ``device``).

    The policy consumes normalized coordinates; report costs on the raw
    coordinates via :func:`tour_cost` (as the reference notebook does with
    its unnormalized TensorDict).
    """
    import torch

    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.utils.device import resolve_device

    coords = problem["node_coords"]
    if coords is None:
        raise ValueError(
            "tsplib_to_tsp_batch needs coordinates; EXPLICIT (matrix-only) "
            "instances have none — use the ATSP env with "
            "tsplib_distance_matrix(problem) as the cost matrix instead."
        )
    locs = normalize_coords(coords) if normalize else coords
    env = get_env("tsp", num_loc=locs.shape[0])
    batch = {"locs": torch.tensor(locs, dtype=torch.float32,
                                  device=resolve_device(device))[None]}
    return env, batch


def vrplib_to_cvrp_batch(problem: dict, normalize: bool = True, device="cuda"):
    """CVRPLIB problem -> (CVRP env, batch of one on ``device``).

    Demands are normalized by vehicle capacity, depot split out of the
    customer list — framework CVRP conventions (node 0 = depot)."""
    import torch

    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.utils.device import resolve_device

    coords = problem["node_coords"]
    demand = problem["demand"]
    assert coords is not None and demand is not None and problem["capacity"]
    depot_idx = problem["depot"]
    locs = normalize_coords(coords) if normalize else coords
    cust = np.ones(len(locs), dtype=bool)
    cust[depot_idx] = False
    env = get_env("cvrp", num_loc=int(cust.sum()), capacity=problem["capacity"])
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=device)[None]

    batch = {
        "locs": tensor(locs[cust]),
        "depot": tensor(locs[depot_idx]),
        "demand": tensor(demand[cust] / problem["capacity"]),
    }
    return env, batch
