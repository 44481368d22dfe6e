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
    """current node embedding + remaining capacity, ``vehicle_capacity``
    less the load (demands are normalized, so the default capacity is 1)."""

    def __init__(self, embed_dim: int, vehicle_capacity: float = 1.0):
        super().__init__()
        self.vehicle_capacity = vehicle_capacity
        self.project_context = nn.Linear(embed_dim + 1, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        remaining = (self.vehicle_capacity - state.used_capacity)[:, None]
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


class VRPTWContext(nn.Module):
    """current node embedding + remaining capacity (``vehicle_capacity``
    less the load) + current time."""

    def __init__(self, embed_dim: int, vehicle_capacity: float = 1.0):
        super().__init__()
        self.vehicle_capacity = vehicle_capacity
        self.project_context = nn.Linear(embed_dim + 2, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        feats = torch.stack([self.vehicle_capacity - state.used_capacity,
                             state.current_time], dim=-1)
        return self.project_context(torch.cat([cur, feats], dim=-1))


class PDPContext(nn.Module):
    """current node embedding alone (PDP's, and SVRP's: the JAX package's
    `SVRPContext` is the same module)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        return self.project_context(gather_rows(embeddings, state.current_node))


class MTSPContext(nn.Module):
    """current node embedding + a projection (``proj_dynamic_feats``) of the
    agents left, the current agent's length, the longest subtour so far and
    the current node's distance from the depot."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj_dynamic_feats = nn.Linear(4, embed_dim, bias=False)
        self.project_context = nn.Linear(2 * embed_dim, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        cur_loc = gather_by_index(state.locs, state.current_node)
        dist_depot = torch.linalg.vector_norm(cur_loc - state.locs[:, 0], dim=-1)
        feats = torch.stack([(state.num_agents - state.agent_idx).float(), state.current_length,
                             state.max_subtour_length, dist_depot], dim=-1)
        return self.project_context(torch.cat([cur, self.proj_dynamic_feats(feats)], dim=-1))


class MTVRPContext(nn.Module):
    """current node embedding + remaining linehaul and backhaul capacity,
    current time, route length and the open-route flag."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 5, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        feats = torch.stack([1.0 - state.used_capacity_linehaul,
                             1.0 - state.used_capacity_backhaul, state.current_time,
                             state.current_route_length, state.open_route.float()], dim=-1)
        return self.project_context(torch.cat([cur, feats], dim=-1))


class MPDPContext(nn.Module):
    """current node embedding + the share of agents still to come, the
    current agent's tour length and the longest tour so far."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 3, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        a = state.lengths.shape[-1]
        agent = state.count_depot.clamp(0, a - 1)
        cur_len = torch.gather(state.lengths, 1, agent[:, None])[:, 0]
        feats = torch.stack([(a - 1 - state.count_depot).float() / a, cur_len,
                             state.lengths.max(dim=-1).values], dim=-1)
        return self.project_context(torch.cat([cur, feats], dim=-1))


class MDCPDPContext(nn.Module):
    """current node embedding + the load carried and the capacity left of
    the current agent."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 2, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_node)                # [B', D]
        cap = torch.gather(state.capacity, 1, state.current_depot[:, None])[:, 0]
        feats = torch.stack([state.current_carry.float(),
                             (cap - state.current_carry).float()], dim=-1)
        return self.project_context(torch.cat([cur, feats], dim=-1))


class DPPContext(nn.Module):
    """No context (DPP's and MDPP's): the placements reach the decoder
    through the mask alone."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        return embeddings.new_zeros((state.i.shape[0], self.embed_dim))


class SMTWTPContext(nn.Module):
    """current job embedding + current time."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim + 1, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        cur = gather_rows(embeddings, state.current_job)                  # [B', D]
        return self.project_context(torch.cat([cur, state.current_time[:, None]], dim=-1))


def softmax_pool(embeddings: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The node embeddings ``[B, N, D]`` weighted by ``softmax(scores [B, N])``
    and summed over the nodes."""
    soft = torch.softmax(scores, dim=-1)
    return (embeddings * soft[..., None].to(embeddings.dtype)).sum(dim=-2)


class FLPContext(nn.Module):
    """The node embeddings pooled by the softmax of each candidate's total
    improvement of the points' distances to the chosen set."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim, embed_dim)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        improve = (state.distances[:, None, :] - state.orig_distances).clamp(min=0.0)
        return self.project_context(softmax_pool(embeddings, improve.sum(dim=-1)))


class MCPContext(nn.Module):
    """The set embeddings pooled by the softmax of each set's weight still
    to cover (0 for a chosen set)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim, embed_dim)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        remaining = state.weights * ~state.covered[:, 1:]                 # [B, I]
        membership = state.membership
        b, s, m = membership.shape
        idx = (membership - 1).clamp(0, remaining.shape[-1] - 1).reshape(b, s * m)
        gathered = torch.gather(remaining, 1, idx).reshape(b, s, m)
        set_weight = (gathered * (membership > 0)).sum(dim=-1)            # [B, S]
        set_weight = torch.where(state.chosen, 0.0, set_weight)
        return self.project_context(softmax_pool(embeddings, set_weight))


CONTEXT_EMBEDDING_REGISTRY = {
    "tsp": TSPContext,
    "shpp": TSPContext,
    "cvrp": VRPContext,
    "cvrpmvc": VRPContext,
    "sdvrp": VRPContext,
    "svrp": PDPContext,
    "mpdp": MPDPContext,
    "mdcpdp": MDCPDPContext,
    "cvrptw": VRPTWContext,
    "pdp": PDPContext,
    "mtsp": MTSPContext,
    "mtvrp": MTVRPContext,
    "op": OPContext,
    "pctsp": PCTSPContext,
    "spctsp": PCTSPContext,
    "smtwtp": SMTWTPContext,
    "dpp": DPPContext,
    "mdpp": DPPContext,
    "flp": FLPContext,
    "mcp": MCPContext,
}


def env_context_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    if env_name not in CONTEXT_EMBEDDING_REGISTRY:
        raise NotImplementedError(
            f"No context embedding ported for env '{env_name}' "
            f"(available: {sorted(CONTEXT_EMBEDDING_REGISTRY)})"
        )
    return CONTEXT_EMBEDDING_REGISTRY[env_name](embed_dim, **kwargs)
