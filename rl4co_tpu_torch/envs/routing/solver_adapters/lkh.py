"""LKH-3 adapter (reference `mtvrp/baselines/lkh.py`).

LKH-3 is an external C solver driven through the `lkh` pip package, which
parses TSPLIB-style problem descriptions. Only explicitly supported VRP
types can be expressed; the variant→type map mirrors the reference
(`baselines/constants.py::ROUTEFINDER2LKH`).
"""

from __future__ import annotations

import numpy as np

from rl4co_tpu_torch.envs.routing.solver_adapters.convert import (
    LKH_SCALING_FACTOR,
    routes_to_action,
    scale_int,
)

# MTVRP variant name -> LKH problem TYPE; None = inexpressible in LKH-3
# (reference `baselines/constants.py`).
VARIANT_TO_LKH_TYPE = {
    "CVRP": "CVRP",
    "OVRP": "OVRP",
    "OVRPB": None,
    "OVRPBL": None,
    "OVRPBLTW": None,
    "OVRPBTW": None,
    "OVRPL": "OVRP",
    "OVRPLTW": "CVRPTW",
    "OVRPMB": "VRPMPD",
    "OVRPMBL": "VRPMPD",
    "OVRPMBTW": "VRPMPDTW",
    "OVRPMBLTW": "VRPMPDTW",
    "OVRPTW": "CVRPTW",
    "VRPB": None,
    "VRPBL": None,
    "VRPBLTW": None,
    "VRPBTW": None,
    "VRPL": "DCVRP",
    "VRPLTW": "CVRPTW",
    "VRPMB": "VRPMPD",
    "VRPMBL": "VRPMPD",
    "VRPMBTW": "VRPMPDTW",
    "VRPMBLTW": None,
    "VRPTW": "CVRPTW",
}


def _import_lkh():
    """Lazy import hook (monkeypatch target for tests)."""
    try:
        import lkh
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ImportError(
            "The `lkh` package (LKH-3 wrapper) is not installed. The adapter "
            "is ready — install it and pass solver_loc= to enable "
            "(reference `baselines/lkh.py`)."
        ) from e
    return lkh


def solve_instance(
    instance: dict,
    max_runtime: float = 10.0,
    problem_type: str = "CVRP",
    num_runs: int = 1,
    solver_loc: str = "LKH",
    **kwargs,
):
    """Solve one instance; returns (giant-tour action list, reward = -cost)."""
    lkh = _import_lkh()
    problem = instance_to_problem(lkh, instance, problem_type)
    routes, cost = lkh.solve(
        solver_loc, problem=problem, time_limit=max_runtime, runs=num_runs,
        **kwargs,
    )
    return routes_to_action(routes), -cost / LKH_SCALING_FACTOR


def instance_to_problem(lkh, instance: dict, problem_type: str):
    """Instance dict -> lkh.LKHProblem via a TSPLIB keyword dict."""
    lkh_type = VARIANT_TO_LKH_TYPE.get(problem_type)
    if lkh_type is None:
        raise ValueError(
            f"Variant {problem_type!r} is not expressible in LKH-3 "
            f"(reference ROUTEFINDER2LKH table)."
        )
    f = LKH_SCALING_FACTOR
    n = np.asarray(instance["locs"]).shape[0]

    specs: dict = {
        "TYPE": lkh_type,
        "DIMENSION": n,
        "CAPACITY": scale_int(instance["vehicle_capacity"], f),
        "EDGE_WEIGHT_TYPE": "EXPLICIT",
        "EDGE_WEIGHT_FORMAT": "FULL_MATRIX",
        "NODE_COORD_TYPE": "TWOD_COORDS",
    }
    dist_limit = float(np.asarray(instance["distance_limit"]))
    if np.isfinite(dist_limit):
        specs["DISTANCE"] = scale_int(dist_limit, f)
    if lkh_type not in ("CVRP", "DCVRP"):
        # quirk: an explicit VEHICLES count makes (D)CVRP hang
        specs["VEHICLES"] = n - 1

    line = scale_int(instance["demand_linehaul"], f)
    back = scale_int(instance["demand_backhaul"], f)
    tw = scale_int(instance["time_windows"], f)
    service = scale_int(instance["service_time"], f)
    matrix = scale_int(instance["cost_matrix"], f)
    if bool(instance.get("open_route", False)):
        matrix = matrix.copy()
        matrix[:, 0] = 0

    sections: dict = {
        "NODE_COORD_SECTION": scale_int(instance["locs"], f),
        "DEMAND_SECTION": line + back,
        "EDGE_WEIGHT_SECTION": matrix,
        "DEPOT_SECTION": [1],
    }
    if "TW" in lkh_type:
        sections["TIME_WINDOW_SECTION"] = tw
        sections["SERVICE_TIME_SECTION"] = service
    if "MPD" in lkh_type:
        # mixed pickup & delivery rows: (idx, delivery, pickup) semantics are
        # encoded per the lkh package's PICKUP_AND_DELIVERY_SECTION
        sections["PICKUP_AND_DELIVERY_SECTION"] = np.stack(
            [np.arange(1, n + 1), line, back], axis=-1
        )

    problem_text = _render_tsplib(specs, sections)
    return lkh.LKHProblem.parse(problem_text)


def _render_tsplib(specs: dict, sections: dict) -> str:
    """Render keyword specs + data sections as TSPLIB text."""
    lines = [f"{k} : {v}" for k, v in specs.items()]
    for name, data in sections.items():
        lines.append(name)
        arr = np.asarray(data)
        if name == "DEPOT_SECTION":
            lines.extend(str(int(v)) for v in arr)
            lines.append("-1")
        elif arr.ndim == 1:
            lines.extend(f"{i + 1} {int(v)}" for i, v in enumerate(arr))
        elif name == "EDGE_WEIGHT_SECTION":
            lines.extend(" ".join(str(int(v)) for v in row) for row in arr)
        else:
            lines.extend(
                f"{i + 1} " + " ".join(str(int(v)) for v in row)
                for i, row in enumerate(arr)
            )
    lines.append("EOF")
    return "\n".join(lines)
