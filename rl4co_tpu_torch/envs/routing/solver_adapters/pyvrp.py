"""PyVRP adapter (reference `mtvrp/baselines/pyvrp.py:14-33`).

PyVRP is an external C++ solver (pip package). The adapter builds a
`ProblemData` model covering all 16 MTVRP variant features: capacities
(linehaul delivery + backhaul pickup), time windows + service times,
per-vehicle distance limits, open routes (zero-cost return arcs), and the
VRPB precedence rule (backhaul→linehaul arcs forbidden).
"""

from __future__ import annotations

import numpy as np

from rl4co_tpu_torch.envs.routing.solver_adapters.convert import (
    PYVRP_SCALING_FACTOR,
    routes_to_action,
    scale_int,
)


def _import_pyvrp():
    """Lazy import hook (monkeypatch target for tests)."""
    try:
        import pyvrp
        from pyvrp.stop import MaxRuntime
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ImportError(
            "PyVRP is not installed. The adapter is ready — install the "
            "`pyvrp` package to enable it (reference `baselines/pyvrp.py`)."
        ) from e
    return pyvrp, MaxRuntime


def solve_instance(instance: dict, max_runtime: float = 10.0, **kwargs):
    """Solve one instance; returns (giant-tour action list, reward = -cost)."""
    pyvrp, MaxRuntime = _import_pyvrp()
    data = instance_to_data(pyvrp, instance)
    result = pyvrp.solve(data, stop=MaxRuntime(max_runtime), **kwargs)
    action = routes_to_action(
        [route.visits() for route in result.best.routes()]
    )
    cost = result.cost() / PYVRP_SCALING_FACTOR
    return action, -cost


def instance_to_data(pyvrp, instance: dict):
    """Instance dict -> pyvrp.ProblemData (integral units)."""
    f = PYVRP_SCALING_FACTOR
    coords = scale_int(instance["locs"], f)
    tw = scale_int(instance["time_windows"], f)
    service = scale_int(instance["service_time"], f)
    pickup = scale_int(instance["demand_backhaul"], f)
    delivery = scale_int(instance["demand_linehaul"], f)
    capacity = scale_int(instance["vehicle_capacity"], f)
    max_distance = scale_int(instance["distance_limit"], f)
    n = coords.shape[0]

    depot = pyvrp.Depot(x=coords[0][0], y=coords[0][1])
    clients = [
        pyvrp.Client(
            x=coords[i][0],
            y=coords[i][1],
            delivery=delivery[i],
            pickup=pickup[i],
            service_duration=service[i],
            tw_early=tw[i][0],
            tw_late=tw[i][1],
        )
        for i in range(1, n)
    ]
    vehicle_type = pyvrp.VehicleType(
        num_available=n - 1,
        capacity=capacity,
        max_distance=max_distance,
        tw_early=tw[0][0],
        tw_late=tw[0][1],
    )

    matrix = scale_int(instance["cost_matrix"], f)
    if bool(instance.get("open_route", False)):
        matrix = matrix.copy()
        matrix[:, 0] = 0  # returning to the depot is free in open routes
    if int(instance.get("backhaul_class", 1)) == 1:
        # traditional VRPB: all linehauls before any backhaul on a route
        line = np.flatnonzero(np.asarray(delivery) > 0)
        back = np.flatnonzero(np.asarray(pickup) > 0)
        if line.size and back.size:
            matrix = matrix.copy()
            matrix[np.ix_(back, line)] = np.iinfo(np.int32).max

    return pyvrp.ProblemData(clients, [depot], [vehicle_type],
                             [matrix], [matrix])
