"""Dynamic embeddings: per-step additions to the decoder's glimpse keys,
values and logit keys (counterpart of
`rl4co_tpu/models/nn/env_embeddings/dynamic.py`).

An env whose node features change while a tour is built (SDVRP's remaining
demands) adds a projection of them to K, V and the logit keys at every
decode step. `StaticEmbedding` is every other env's: it adds nothing, and
the AM decoder skips it. An env in `DYNAMIC_EMBEDDING_REGISTRY` decodes with
its cache tiled per repeat (`models/policies/constructive.py`), since each
start's K/V differ.
"""

from __future__ import annotations

import torch
from torch import nn


class StaticEmbedding(nn.Module):
    """No parameters, no addition: the env's node features never change."""

    def __init__(self, embed_dim: int):
        super().__init__()

    def forward(self, state):
        return 0.0, 0.0, 0.0


class SDVRPDynamicEmbedding(nn.Module):
    """The remaining demands ``[B, N+1]`` (depot slot 0) through
    ``projection`` (1 -> 3D, no bias), split into the K, V and logit-key
    deltas ``[B, N+1, D]`` each."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.projection = nn.Linear(1, 3 * embed_dim, bias=False)

    def forward(self, state):
        return self.projection(state.demand_with_depot[..., None]).chunk(3, dim=-1)


class JSSPDynamicEmbedding(nn.Module):
    """The scheduling deltas of L2D's attention policy, which read the
    encoder's machine embeddings: they come with L2D."""

    def __init__(self, embed_dim: int, **kwargs):
        raise NotImplementedError(
            "JSSPDynamicEmbedding (L2D) is not ported to rl4co_tpu_torch yet (ROADMAP.md, item 14)")


DYNAMIC_EMBEDDING_REGISTRY = {
    "sdvrp": SDVRPDynamicEmbedding,
}


def env_dynamic_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    """The env's dynamic embedding, `StaticEmbedding` for an env without one."""
    return DYNAMIC_EMBEDDING_REGISTRY.get(env_name, StaticEmbedding)(embed_dim, **kwargs)
