"""Environment registry (counterpart of `rl4co_tpu/envs/__init__.py`)."""

from rl4co_tpu_torch.envs.base import Env, Instance  # noqa: F401
from rl4co_tpu_torch.envs.routing.cvrp import CVRP
from rl4co_tpu_torch.envs.routing.op import OP
from rl4co_tpu_torch.envs.routing.pctsp import PCTSP, SPCTSP
from rl4co_tpu_torch.envs.routing.tsp import TSP

ENV_REGISTRY = {
    "tsp": TSP,
    "cvrp": CVRP,
    "op": OP,
    "pctsp": PCTSP,
    "spctsp": SPCTSP,
}


def get_env(name: str, **kwargs) -> Env:
    """Instantiate an env by registry name."""
    cls = ENV_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"Environment '{name}' is not ported yet (available: "
            f"{sorted(ENV_REGISTRY)}); ROADMAP.md lists the order of the rest"
        )
    return cls(**kwargs)
