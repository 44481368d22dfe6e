from rl4co_tpu_torch.rl.baselines import get_reinforce_baseline, REINFORCE_BASELINES  # noqa: F401
from rl4co_tpu_torch.rl.reinforce import REINFORCE  # noqa: F401
from rl4co_tpu_torch.rl.critic import CriticNetwork  # noqa: F401
