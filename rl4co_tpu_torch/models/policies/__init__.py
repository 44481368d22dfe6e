from rl4co_tpu_torch.models.policies.constructive import (  # noqa: F401
    ConstructivePolicy,
    PrecomputedCache,
    RolloutOutput,
    rollout,
)
