"""Everything a run feeds both sides, made from ``--seed`` on the device:
random streams, weights and instances.

Instances follow the published generators (frozen copies of the port's
`TSP.generate` and `CVRP.generate`): coordinates uniform in the unit square,
CVRP's depot likewise, integer demands uniform in ``[min_demand,
max_demand)`` divided by the vehicle's capacity.
"""

from __future__ import annotations

import numpy as np
import torch

# independent streams of one seed
WEIGHTS, INSTANCES, SAMPLING, CHECK = 1, 2, 3, 4


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of ``seed``; neighbouring seeds and
    streams give unrelated numbers."""
    words = np.random.SeedSequence([seed % 2**64, stream]).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def make_weights(schema, gen: torch.Generator, device) -> dict:
    """One uniform draw for all weights, mapped leaf by leaf onto the
    distribution `schema` names."""
    total = sum(int(np.prod(shape)) for _, shape, _ in schema)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, (kind, a, b) in schema:
        n = int(np.prod(shape))
        x = u[at:at + n].reshape(shape)
        at += n
        if kind == "uniform":
            out[name] = (2.0 * x - 1.0) * a
        elif kind == "range":
            out[name] = a + (b - a) * x
        elif kind == "const":
            out[name] = torch.full(shape, a, device=device)
        else:
            raise ValueError(f"unknown weight distribution {kind!r} of {name}")
    return out


def make_instances(cfg: dict, count: int, gen: torch.Generator, device) -> dict:
    n = cfg["num_loc"]
    locs = torch.rand((count, n, 2), generator=gen, device=device)
    if cfg["env"] == "tsp":
        return {"locs": locs}
    depot = torch.rand((count, 2), generator=gen, device=device)
    demand = torch.randint(cfg["min_demand"], cfg["max_demand"], (count, n), generator=gen,
                           device=device).float()
    return {"locs": locs, "depot": depot, "demand": demand / cfg["capacity"]}
