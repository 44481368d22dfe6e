from rl4co_tpu_torch.envs.scheduling.smtwtp import SMTWTP, SMTWTPState  # noqa: F401
from rl4co_tpu_torch.envs.scheduling.ffsp import FFSP, FFSPState  # noqa: F401
from rl4co_tpu_torch.envs.scheduling.fjsp import FJSP, JSSP, FJSPState  # noqa: F401
