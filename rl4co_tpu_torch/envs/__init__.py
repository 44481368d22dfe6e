"""Environment registry (counterpart of `rl4co_tpu/envs/__init__.py`)."""

from rl4co_tpu_torch.envs.base import Env, Instance  # noqa: F401
from rl4co_tpu_torch.envs.eda.dpp import DPP, MDPP
from rl4co_tpu_torch.envs.graph.flp import FLP
from rl4co_tpu_torch.envs.graph.mcp import MCP
from rl4co_tpu_torch.envs.routing.atsp import ATSP
from rl4co_tpu_torch.envs.routing.cvrp import CVRP
from rl4co_tpu_torch.envs.routing.cvrpmvc import CVRPMVC
from rl4co_tpu_torch.envs.routing.cvrptw import CVRPTW
from rl4co_tpu_torch.envs.routing.mdcpdp import MDCPDP
from rl4co_tpu_torch.envs.routing.mpdp import MPDP
from rl4co_tpu_torch.envs.routing.mtsp import MTSP, SHPP
from rl4co_tpu_torch.envs.routing.mtvrp import MTVRP
from rl4co_tpu_torch.envs.routing.op import OP
from rl4co_tpu_torch.envs.routing.pctsp import PCTSP, SPCTSP
from rl4co_tpu_torch.envs.routing.pdp import PDP
from rl4co_tpu_torch.envs.routing.sdvrp import SDVRP
from rl4co_tpu_torch.envs.routing.svrp import SVRP
from rl4co_tpu_torch.envs.routing.tsp import TSP, DenseRewardTSP  # noqa: F401
from rl4co_tpu_torch.envs.scheduling.ffsp import FFSP
from rl4co_tpu_torch.envs.scheduling.fjsp import FJSP, JSSP
from rl4co_tpu_torch.envs.scheduling.smtwtp import SMTWTP

ENV_REGISTRY = {
    "tsp": TSP,
    "cvrp": CVRP,
    "op": OP,
    "pctsp": PCTSP,
    "spctsp": SPCTSP,
    "cvrptw": CVRPTW,
    "sdvrp": SDVRP,
    "pdp": PDP,
    "mtsp": MTSP,
    "shpp": SHPP,
    "mtvrp": MTVRP,
    "svrp": SVRP,
    "cvrpmvc": CVRPMVC,
    "mpdp": MPDP,
    "mdcpdp": MDCPDP,
    "flp": FLP,
    "mcp": MCP,
    "smtwtp": SMTWTP,
    "dpp": DPP,
    "mdpp": MDPP,
    "atsp": ATSP,
    "ffsp": FFSP,
    "fjsp": FJSP,
    "jssp": JSSP,
}


def register_env(name: str, cls) -> None:
    """Add ``cls`` to the registry under ``name`` (a user's own env)."""
    ENV_REGISTRY[name] = cls


def get_env(name: str, **kwargs) -> Env:
    """Instantiate an env by registry name."""
    cls = ENV_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"Unknown environment '{name}' (available: {sorted(ENV_REGISTRY)})")
    return cls(**kwargs)
