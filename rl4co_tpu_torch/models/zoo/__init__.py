"""Model zoo. Exports are lazy (PEP 562), as the JAX package's zoo: a zoo
module imports the RL algorithms, which import the policy engine."""

import importlib

_EXPORTS = {
    "AttentionModel": "am",
    "AMPPO": "am",
    "AttentionModelPolicy": "am",
    "GLOP": "glop",
    "GLOPVRPAdapter": "glop",
    "batched_random_insertion": "glop",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'rl4co_tpu_torch.models.zoo' has no attribute {name!r}")
    return getattr(importlib.import_module(f"rl4co_tpu_torch.models.zoo.{module}"), name)
