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
    """The scheduling deltas of L2D's attention policy. It reads the
    encoder's machine embeddings, so `models/zoo/l2d.py::L2DAttnPolicy`
    calls it and the routing registry does not hold it. Per decode step each
    job's K, V and logit key get two additions:

    - a node term, ``project_node_step`` (2 -> 3D, no bias) of the job's
      next operation's (lower bound left, scaled; readiness);
    - an edge term: the operation's processing times, zero on busy machines
      and scaled, through ``project_edge_step`` (1 -> 3, no bias), mixed
      with the machine embeddings.
    """

    def __init__(self, embed_dim: int, scaling_factor: float = 1000.0):
        super().__init__()
        self.embed_dim, self.scaling_factor = embed_dim, scaling_factor
        self.project_node_step = nn.Linear(2, 3 * embed_dim, bias=False)
        self.project_edge_step = nn.Linear(1, 3, bias=False)

    def forward(self, state, ma_emb, lbs, is_ready):
        """``state``: FJSP/JSSP state; ``ma_emb [B, M, D]``; ``lbs`` and
        ``is_ready [B, O]``. Returns the K, V and logit-key deltas ``[B, J, D]``."""
        d = self.embed_dim
        lbs_c = (lbs - state.time[:, None]).clamp(min=0.0) / self.scaling_factor
        update_feat = torch.stack([lbs_c, is_ready.float()], dim=-1)            # [B, O, 2]
        job_feat = torch.gather(update_feat, 1, state.next_op[..., None].expand(-1, -1, 2))
        updates = self.project_node_step(job_feat)                               # [B, J, 3D]
        ma_busy = state.busy_until > state.time[:, None]                         # [B, M]
        masked_proc = torch.where(ma_busy[:, :, None], 0.0,
                                  state.proc_times / self.scaling_factor).transpose(1, 2)
        edge_feat = self.project_edge_step(masked_proc[..., None])               # [B, O, M, 3]
        m = edge_feat.shape[2]
        job_edge = torch.gather(edge_feat, 1,
                                state.next_op[:, :, None, None].expand(-1, -1, m, 3))
        edge_upd = torch.einsum("bjms,bmd->bjsd", job_edge, ma_emb)
        updates = updates + edge_upd.reshape(*edge_upd.shape[:-2], 3 * d)
        return updates.chunk(3, dim=-1)


DYNAMIC_EMBEDDING_REGISTRY = {
    "sdvrp": SDVRPDynamicEmbedding,
}


def env_dynamic_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    """The env's dynamic embedding, `StaticEmbedding` for an env without one."""
    return DYNAMIC_EMBEDDING_REGISTRY.get(env_name, StaticEmbedding)(embed_dim, **kwargs)
