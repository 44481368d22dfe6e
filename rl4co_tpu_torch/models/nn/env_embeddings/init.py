"""Initial (node-feature → embedding) modules per environment (counterpart
of `rl4co_tpu/models/nn/env_embeddings/init.py`). Each module maps a batched
instance dict to node embeddings ``[B, N_actions, D]``.
"""

from __future__ import annotations

import torch
from torch import nn


class TSPInitEmbedding(nn.Module):
    """xy coords → embedding."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed = nn.Linear(2, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        return self.init_embed(instance["locs"])


class VRPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + demand) embedded by two layers; the
    depot is row 0, as in the env's action indexing."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim)
        self.init_embed = nn.Linear(3, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["demand"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class OPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + prize)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim)
        self.init_embed = nn.Linear(3, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["prize"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class PCTSPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + expected prize + penalty): SPCTSP too
    embeds the expected (deterministic) prize, not the realised one."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim)
        self.init_embed = nn.Linear(4, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["deterministic_prize"][..., None],
                           instance["penalty"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


INIT_EMBEDDING_REGISTRY = {
    "tsp": TSPInitEmbedding,
    "cvrp": VRPInitEmbedding,
    "op": OPInitEmbedding,
    "pctsp": PCTSPInitEmbedding,
    "spctsp": PCTSPInitEmbedding,
}


def env_init_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    if env_name not in INIT_EMBEDDING_REGISTRY:
        raise NotImplementedError(
            f"No init embedding ported for env '{env_name}' "
            f"(available: {sorted(INIT_EMBEDDING_REGISTRY)})"
        )
    return INIT_EMBEDDING_REGISTRY[env_name](embed_dim, **kwargs)
