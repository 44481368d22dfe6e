"""Edge embeddings for the NAR encoders (counterpart of
`rl4co_tpu/models/nn/env_embeddings/edge.py`).

Edges live in a static top-K neighbour layout: ``knn_edges`` returns
``nbr_idx [B, N, K]`` (the K nearest other nodes of each node) and their
distances. The neighbour order is the JAX package's to the index: distances
come from `torch.linalg.vector_norm` (which rounds as `jnp.linalg.norm`), and
a stable ascending sort breaks ties toward the lower index, as
`jax.lax.top_k` does. Every later value is gathered through ``nbr_idx``.
"""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.utils.ops import get_distance_matrix


def default_k_sparse(num_nodes: int) -> int:
    """k = max(n // 5, 10), capped at n - 1 (100 at N 500)."""
    return min(max(num_nodes // 5, 10), num_nodes - 1)


def knn_edges_from_matrix(dm: torch.Tensor, k: int):
    """Row-wise K smallest entries of ``dm [B, N, N]``, the diagonal excluded
    (+1e9): ``(nbr_idx [B, N, K] int64, dist [B, N, K])``."""
    n = dm.shape[-1]
    dm_self = dm + torch.eye(n, dtype=dm.dtype, device=dm.device) * 1e9
    order = torch.sort(dm_self, dim=-1, stable=True).indices[..., :k]
    return order, torch.gather(dm_self, -1, order)


def knn_edges(locs: torch.Tensor, k: int):
    """``locs [B, N, 2]`` -> (nbr_idx [B, N, K] of the K nearest other nodes,
    dist [B, N, K])."""
    return knn_edges_from_matrix(get_distance_matrix(locs), k)


class TSPEdgeEmbedding(nn.Module):
    """Distance -> edge feature, one Dense (``edge_embed``)."""

    def __init__(self, embed_dim: int, k_sparse: int | None = None):
        super().__init__()
        self.k_sparse = k_sparse
        self.edge_embed = nn.Linear(1, embed_dim)

    def node_locs(self, instance) -> torch.Tensor:
        return instance["locs"]

    def forward(self, instance):
        locs = self.node_locs(instance)
        nbr_idx, dist = knn_edges(locs, self.k_sparse or default_k_sparse(locs.shape[-2]))
        return self.edge_embed(dist[..., None]), nbr_idx


class VRPEdgeEmbedding(TSPEdgeEmbedding):
    """The depot and the customers: the depot is row 0, as in the env's
    action indexing."""

    def node_locs(self, instance) -> torch.Tensor:
        return torch.cat([instance["depot"][:, None, :], instance["locs"]], dim=-2)


class ATSPEdgeEmbedding(nn.Module):
    """The K cheapest arcs out of each node of the cost matrix (row-wise,
    the diagonal excluded) -> edge features, one Dense (``edge_embed``)."""

    def __init__(self, embed_dim: int, k_sparse: int | None = None):
        super().__init__()
        self.k_sparse = k_sparse
        self.edge_embed = nn.Linear(1, embed_dim)

    def forward(self, instance):
        dm = instance["cost_matrix"]
        nbr_idx, dist = knn_edges_from_matrix(dm, self.k_sparse or default_k_sparse(dm.shape[-1]))
        return self.edge_embed(dist[..., None]), nbr_idx


EDGE_EMBEDDING_REGISTRY = {
    "tsp": TSPEdgeEmbedding,
    "shpp": TSPEdgeEmbedding,
    "cvrp": VRPEdgeEmbedding,
    "op": VRPEdgeEmbedding,
    "pctsp": VRPEdgeEmbedding,
    "spctsp": VRPEdgeEmbedding,
    "atsp": ATSPEdgeEmbedding,
}


def env_edge_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    if env_name not in EDGE_EMBEDDING_REGISTRY:
        raise ValueError(f"No edge embedding for env '{env_name}'. "
                         f"Available: {sorted(EDGE_EMBEDDING_REGISTRY)}")
    return EDGE_EMBEDDING_REGISTRY[env_name](embed_dim, **kwargs)
