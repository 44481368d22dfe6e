"""Classical-solver adapters for MTVRP (counterpart of
`rl4co_tpu/envs/routing/solver_adapters/`; reference
`rl4co/envs/routing/mtvrp/baselines/{solve,pyvrp,lkh,ortools}.py`).

Each adapter converts one host-side instance dict (numpy arrays) to the
external solver's native model, runs it, and converts the solution back to
the giant-tour action encoding (customer indices with 0 = depot separators).
External packages are imported lazily inside `_import_*` hooks, so the
adapters can be tested with fake modules, and raise ImportError when the
package is absent.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from rl4co_tpu_torch.envs.routing.solver_adapters import convert

SOLVERS = ("pyvrp", "lkh", "ortools")


def solve_batch(
    instances,
    solver: str,
    max_runtime: float = 10.0,
    num_procs: int = 1,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Solve a batched instance dict (numpy arrays or tensors) with an
    external solver.

    Mirrors the reference dispatch (`baselines/solve.py:29-83`): split the
    batch into per-instance dicts, fan out over a process pool, pad actions
    to equal length. Returns ``(actions [B, T], rewards [B])`` with
    reward = -cost (the reference adapters return the negated cost too).
    """
    if solver == "pyvrp":
        from rl4co_tpu_torch.envs.routing.solver_adapters import pyvrp as mod
    elif solver == "lkh":
        from rl4co_tpu_torch.envs.routing.solver_adapters import lkh as mod
    elif solver == "ortools":
        from rl4co_tpu_torch.envs.routing.solver_adapters import ortools as mod
    else:
        raise ValueError(f"Unknown solver {solver!r}. Available: {SOLVERS}")

    per_instance = convert.split_batch(instances)
    fn = partial(mod.solve_instance, max_runtime=max_runtime, **kwargs)
    if num_procs > 1:
        from multiprocessing import Pool

        with Pool(processes=num_procs) as pool:
            results = pool.map(fn, per_instance)
    else:
        results = [fn(inst) for inst in per_instance]

    actions, costs = zip(*results)
    max_len = max(len(a) for a in actions)
    actions = np.array(
        [list(a) + [0] * (max_len - len(a)) for a in actions], dtype=np.int64
    )
    return actions, np.asarray(costs, dtype=np.float64)
