"""OR-Tools adapter (reference `mtvrp/baselines/ortools.py`).

Builds a `RoutingModel` directly from the instance dict (the reference
converts through PyVRP's ProblemData first; here the conversion is direct):
distance arc costs, capacity + backhaul dimensions, optional max-distance
and time-window dimensions, open routes via zero-cost depot return arcs,
and VRPB precedence via forbidden backhaul→linehaul arcs.
"""

from __future__ import annotations

import numpy as np

from rl4co_tpu_torch.envs.routing.solver_adapters.convert import (
    ORTOOLS_SCALING_FACTOR,
    routes_to_action,
    scale_int,
)


def _import_ortools():
    """Lazy import hook (monkeypatch target for tests)."""
    try:
        from ortools.constraint_solver import pywrapcp, routing_enums_pb2
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ImportError(
            "OR-Tools is not installed. The adapter is ready — install the "
            "`ortools` package to enable it (reference `baselines/ortools.py`)."
        ) from e
    return pywrapcp, routing_enums_pb2


def solve_instance(instance: dict, max_runtime: float = 10.0, **kwargs):
    """Solve one instance; returns (giant-tour action list, reward = -cost)."""
    pywrapcp, enums = _import_ortools()
    f = ORTOOLS_SCALING_FACTOR
    n = np.asarray(instance["locs"]).shape[0]
    num_vehicles = n - 1

    matrix = scale_int(instance["cost_matrix"], f)
    if bool(instance.get("open_route", False)):
        matrix = matrix.copy()
        matrix[:, 0] = 0
    line = scale_int(instance["demand_linehaul"], f)
    back = scale_int(instance["demand_backhaul"], f)
    capacity = scale_int(instance["vehicle_capacity"], f)
    max_distance = scale_int(instance["distance_limit"], f)
    tw = scale_int(instance["time_windows"], f)
    service = scale_int(instance["service_time"], f)
    has_tw = bool(np.isfinite(np.asarray(instance["time_windows"])[1:, 1]).any())
    has_backhaul = bool((np.asarray(back) > 0).any())

    if has_backhaul and int(instance.get("backhaul_class", 1)) == 1:
        l_idx = np.flatnonzero(line > 0)
        b_idx = np.flatnonzero(back > 0)
        matrix = matrix.copy()
        matrix[np.ix_(b_idx, l_idx)] = max_distance

    manager = pywrapcp.RoutingIndexManager(n, num_vehicles, 0)
    routing = pywrapcp.RoutingModel(manager)

    dist_cb = routing.RegisterTransitMatrix(matrix.tolist())
    routing.SetArcCostEvaluatorOfAllVehicles(dist_cb)
    routing.AddDimension(dist_cb, 0, int(max_distance), True, "Distance")
    routing.AddDimensionWithVehicleCapacity(
        routing.RegisterUnaryTransitVector(line.tolist()),
        0, [int(capacity)] * num_vehicles, True, "Demand",
    )
    if has_backhaul:
        routing.AddDimensionWithVehicleCapacity(
            routing.RegisterUnaryTransitVector(back.tolist()),
            0, [int(capacity)] * num_vehicles, True, "Backhaul",
        )
    if has_tw:
        durations = np.asarray(matrix) + np.asarray(service)[:, None]
        depot_late = int(tw[0][1])
        routing.AddDimension(
            routing.RegisterTransitMatrix(durations.tolist()),
            depot_late, depot_late, False, "Time",
        )
        time_dim = routing.GetDimensionOrDie("Time")
        for node in range(1, n):
            time_dim.CumulVar(manager.NodeToIndex(node)).SetRange(
                int(tw[node][0]), int(tw[node][1])
            )
        for v in range(num_vehicles):
            time_dim.CumulVar(routing.Start(v)).SetRange(int(tw[0][0]), depot_late)
            routing.AddVariableMinimizedByFinalizer(
                time_dim.CumulVar(routing.Start(v))
            )
            routing.AddVariableMinimizedByFinalizer(
                time_dim.CumulVar(routing.End(v))
            )

    params = pywrapcp.DefaultRoutingSearchParameters()
    params.first_solution_strategy = (
        enums.FirstSolutionStrategy.PATH_CHEAPEST_ARC
    )
    params.local_search_metaheuristic = (
        enums.LocalSearchMetaheuristic.GUIDED_LOCAL_SEARCH
    )
    params.time_limit.FromSeconds(int(max(1, round(max_runtime))))
    solution = routing.SolveWithParameters(params)
    if solution is None:
        raise RuntimeError("OR-Tools found no feasible solution")

    routes = []
    for v in range(num_vehicles):
        idx = routing.Start(v)
        route = []
        while not routing.IsEnd(idx):
            node = manager.IndexToNode(idx)
            if node != 0:
                route.append(node)
            idx = solution.Value(routing.NextVar(idx))
        if route:
            routes.append(route)
    cost = solution.ObjectiveValue() / ORTOOLS_SCALING_FACTOR
    return routes_to_action(routes), -cost
