from rl4co_tpu_torch.envs.graph.flp import FLP, FLPState  # noqa: F401
from rl4co_tpu_torch.envs.graph.mcp import MCP, MCPState  # noqa: F401
