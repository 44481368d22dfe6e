from rl4co_tpu_torch.envs.routing.tsp import TSP, TSPState  # noqa: F401
from rl4co_tpu_torch.envs.routing.cvrp import CVRP, CVRPState  # noqa: F401
from rl4co_tpu_torch.envs.routing.op import OP, OPState  # noqa: F401
from rl4co_tpu_torch.envs.routing.pctsp import PCTSP, SPCTSP, PCTSPState  # noqa: F401
