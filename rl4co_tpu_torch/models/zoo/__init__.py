"""Model zoo. Exports are lazy (PEP 562), as the JAX package's zoo: a zoo
module imports the RL algorithms, which import the policy engine."""

import importlib

_EXPORTS = {
    "AttentionModel": "am",
    "AMPPO": "am",
    "AttentionModelPolicy": "am",
    "DACT": "dact",
    "N2S": "n2s",
    "NeuOpt": "neuopt",
    "MatNet": "matnet",
    "HeterogeneousAttentionModel": "ham",
    "HeterogeneousAttentionModelPolicy": "ham",
    "MVMoE_AM": "mvmoe",
    "MVMoE_POMO": "mvmoe",
    "NARGNNPolicy": "nargnn",
    "EAS": "eas",
    "PointerNetworkPolicy": "ptrnet",
    "POMO": "pomo",
    "make_pomo_policy": "pomo",
    "SymNCO": "symnco",
    "SymNCOPolicy": "symnco",
    "PolyNet": "polynet",
    "PolyNetPolicy": "polynet",
    "MVMoEPolicy": "mvmoe",
    "MatNetPolicy": "matnet",
    "MatNetFFSPPolicy": "matnet_ffsp",
    "MDAM": "mdam",
    "MDAMPolicy": "mdam",
    "HAMPolicy": "ham",
    "NARGNNEncoder": "nargnn",
    "NonAutoregressivePolicy": "nargnn",
    "DeepACO": "deepaco",
    "run_ant_system": "deepaco",
    "GFACS": "gfacs",
    "GFACSEncoder": "gfacs",
    "GLOP": "glop",
    "GLOPVRPAdapter": "glop",
    "batched_random_insertion": "glop",
    "DACTPolicy": "dact",
    "ImprovementCritic": "dact",
    "dact_act": "dact",
    "N2SPolicy": "n2s",
    "n2s_act": "n2s",
    "NeuOptPolicy": "neuopt",
    "neuopt_act": "neuopt",
    "ActiveSearch": "eas",
    "EASEmb": "eas",
    "EASLay": "eas",
    "PointerNetwork": "ptrnet",
    "PointerNetworkModel": "ptrnet",
    "L2DModel": "l2d",
    "L2DPolicy": "l2d",
    "l2d_rollout": "l2d",
    "L2DAttnModel": "l2d",
    "L2DAttnPolicy": "l2d",
    "l2d_attn_rollout": "l2d",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'rl4co_tpu_torch.models.zoo' has no attribute {name!r}")
    return getattr(importlib.import_module(f"rl4co_tpu_torch.models.zoo.{module}"), name)
