from rl4co_tpu_torch.models.policies.constructive import (  # noqa: F401
    ConstructivePolicy,
    PrecomputedCache,
    RolloutOutput,
    rollout,
)
# the AM policy directly, not through models.zoo: the zoo imports the RL
# algorithms, which import this package
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy  # noqa: F401


def __getattr__(name):
    # the whole zoo at `rl4co_tpu_torch.models.<Name>`, lazily (the zoo -> rl
    # -> models cycle)
    from rl4co_tpu_torch.models import zoo

    if name in zoo.__all__:
        return getattr(zoo, name)
    raise AttributeError(f"module 'rl4co_tpu_torch.models' has no attribute {name!r}")
