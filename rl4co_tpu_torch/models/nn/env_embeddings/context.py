"""Context (decoder-query) modules per environment (counterpart of
`rl4co_tpu/models/nn/env_embeddings/context.py`): the decode-step query is
``project_context`` of the current node's embedding concatenated with the
env's state features (TSP: the first node's embedding; CVRP: the remaining
capacity; OP: the remaining length budget; PCTSP: the prize still required).

Modules consume ``(node_embs [B, N, D], state)`` with the batched env state.
"""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.utils.ops import gather_by_index


def gather_rows(embeddings: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` of each instance's node embeddings ``[B, N, D]``.

    ``idx [B]`` gives ``[B, D]``. For grouped decode, a flat repeat-major
    state ``[g*B]`` reads the untiled embeddings through a ``[B, g]`` index
    (no g-fold copy of them) and gives ``[g*B, D]``."""
    b = embeddings.shape[0]
    if idx.shape[0] == b:
        return gather_by_index(embeddings, idx)
    g = idx.shape[0] // b
    out = gather_by_index(embeddings, idx.reshape(g, b).t())  # [B, g, D]
    return out.transpose(0, 1).reshape(g * b, -1)


class TSPContext(nn.Module):
    """first+current node embeddings; a learned placeholder before the first
    step. The stored ``W_placeholder`` is ~U(0, 2) and is used as
    ``W_placeholder - 1.0``, exactly as the JAX package stores and uses it."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.W_placeholder = nn.Parameter(torch.rand(2 * embed_dim) * 2.0)
        self.project_context = nn.Linear(2 * embed_dim, embed_dim, bias=False)

    def round_parameters(self, dtype: torch.dtype) -> dict:
        """Under a compute dtype the JAX package subtracts the 1.0 from the
        placeholder cast to it, in that dtype, and rounds again. The value
        given here makes ``value - 1.0`` that twice-rounded number in f32:
        it is a multiple of 2**-8 in [-1, 1) in bf16, so adding and taking
        1.0 in f32 is exact. See `rl4co_tpu_torch/utils/dtype.py`."""
        w = self.W_placeholder
        return {"W_placeholder": (w.to(dtype) - 1.0).to(w.dtype) + 1.0}

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        first = gather_rows(embeddings, state.first_node)      # [B', D]
        cur = gather_rows(embeddings, state.current_node)      # [B', D]
        ctx = torch.cat([first, cur], dim=-1)                  # [B', 2D]
        is_first = (state.i < 1)[:, None]
        ctx = torch.where(is_first, (self.W_placeholder - 1.0)[None, :], ctx)
        return self.project_context(ctx)


class VRPContext(nn.Module):
    """current node embedding + remaining capacity (demands are normalized,
    so the vehicle's capacity is 1)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 1, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        remaining = (1.0 - state.used_capacity)[:, None]
        return self.project_context(torch.cat([cur, remaining], dim=-1))


class OPContext(nn.Module):
    """current node embedding + remaining length budget (the depot's
    adjusted budget minus the tour so far)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 1, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        remaining = (state.max_length[:, 0] - state.tour_length)[:, None]
        return self.project_context(torch.cat([cur, remaining], dim=-1))


class PCTSPContext(nn.Module):
    """current node embedding + the realised prize still required, clamped at 0."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 1, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        remaining = torch.clamp(state.prize_required - state.cur_total_prize, min=0.0)[:, None]
        return self.project_context(torch.cat([cur, remaining], dim=-1))


CONTEXT_EMBEDDING_REGISTRY = {
    "tsp": TSPContext,
    "cvrp": VRPContext,
    "op": OPContext,
    "pctsp": PCTSPContext,
    "spctsp": PCTSPContext,
}


def env_context_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    if env_name not in CONTEXT_EMBEDDING_REGISTRY:
        raise NotImplementedError(
            f"No context embedding ported for env '{env_name}' "
            f"(available: {sorted(CONTEXT_EMBEDDING_REGISTRY)})"
        )
    return CONTEXT_EMBEDDING_REGISTRY[env_name](embed_dim, **kwargs)
