"""Multi-environment policy: one shared trunk, per-env embeddings
(counterpart of `rl4co_tpu/models/policies/multi_env.py`).

The policy owns every env's init and context embedding, registered under the
JAX package's per-env names (``init_embeddings_op``,
``context_embeddings_pctsp``, ...), and one encoder, node projection, graph
context and pointer that all envs share. ``env_name`` selects the *active*
embeddings; `for_env` returns a view of the same module with another active
env. The view shares the parameters themselves (its sub-module table is the
parent's), is registered nowhere, and has the same ``state_dict`` keys: an
optimiser built on the parent sees each parameter once, whatever env a step
runs.

OP and PCTSP have no dynamic embedding (the JAX package's `StaticEmbedding`
holds no parameter and adds nothing), so none is ported here.

The JAX package's `init_multi_env_params` and `touch_all` only make Flax
create its lazily initialised parameters of every env; a PyTorch module has
all of them from construction, so they have no counterpart.
"""

from __future__ import annotations

import copy

from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy
from rl4co_tpu_torch.models.zoo.mvmoe import MVMoEPolicy


class MultiEnvAttentionPolicy(AttentionModelPolicy):
    """AM policy with per-env embeddings and a shared encoder/pointer trunk.

    ``env_names`` fixes the full set (and so the parameters); ``env_name``
    is the active one, the first by default.
    """

    def __init__(self, env_name: str = "op", env_names: tuple = ("op", "pctsp"), **kwargs):
        if env_name not in env_names:
            raise ValueError(f"active env {env_name!r} not in {tuple(env_names)}")
        self.env_names = tuple(env_names)
        super().__init__(env_name=env_name, **kwargs)

    def _add_embedding(self, name: str, make, kwargs) -> None:
        for n in self.env_names:
            self.add_module(f"{name}s_{n}", make(n, self.embed_dim, **(kwargs or {})))

    @property
    def init_embedding(self):
        return self._modules[f"init_embeddings_{self.env_name}"]

    @property
    def context_embedding(self):
        return self._modules[f"context_embeddings_{self.env_name}"]

    def for_env(self, name: str) -> "MultiEnvAttentionPolicy":
        """The same trunk and parameters with ``name``'s embeddings active: a
        shallow copy, whose parameter and sub-module tables are this module's
        own dicts."""
        if name not in self.env_names:
            raise ValueError(f"env {name!r} not in {self.env_names}")
        view = copy.copy(self)
        view.env_name = name
        return view


class MultiEnvMoEPolicy(MultiEnvAttentionPolicy, MVMoEPolicy):
    """Multi-env policy with MVMoE's trunk: MoE encoder layers
    (``moe_layer_{i}``) and the MoE pointer projection (`PointerAttnMoE`,
    which reaches no kernel), embeddings per env as above. As in MVMoE, it
    owns no dense ``encoder_net``: the JAX package builds one and never calls
    it, so its tree holds none. ``num_experts`` (4) and ``moe_topk`` (2) as
    MVMoE's."""
