"""The Synth-Attention encoder of N2S (Ma et al. 2022), shared by N2S and
NeuOpt (counterpart of `rl4co_tpu/models/zoo/n2s_encoder.py`): self-attention
whose per-head scores are mixed with positional compatibility scores by a
small MLP. Sub-modules carry the Flax module's names."""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import MultiHeadCompat
from rl4co_tpu_torch.models.nn.ops import Normalization
from rl4co_tpu_torch.models.nn.pos_embeddings import pos_init_embedding
from rl4co_tpu_torch.models.zoo.dact import merge_heads, split_heads


class SynthAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        for name in ("W_query", "W_key", "W_val", "W_out"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim, bias=False))
        self.score_aggr_0 = nn.Linear(2 * num_heads, 2 * num_heads)
        self.score_aggr_1 = nn.Linear(2 * num_heads, num_heads)

    def forward(self, h, aux_score):
        """h ``[B, N, D]``, aux_score ``[H, B, N, N]`` -> (h', aux_score)."""
        q, k, v = (split_heads(getattr(self, n)(h), self.num_heads)
                   for n in ("W_query", "W_key", "W_val"))
        compat = torch.cat([q @ k.transpose(-1, -2), aux_score.movedim(0, 1)], dim=1)
        agg = self.score_aggr_1(torch.relu(self.score_aggr_0(compat.movedim(1, -1))))
        attn = torch.softmax(agg.movedim(-1, 1), dim=-1)                 # [B, H, N, N]
        return self.W_out(merge_heads(attn @ v)), aux_score


class N2SEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4, feedforward_hidden: int = 128,
                 normalization: str = "layer"):
        super().__init__()
        self.synth_att = SynthAttention(embed_dim, num_heads)
        self.norm1 = Normalization(embed_dim, normalization)
        self.ff1 = nn.Linear(embed_dim, feedforward_hidden, bias=False)
        self.ff2 = nn.Linear(feedforward_hidden, embed_dim, bias=False)
        self.norm2 = Normalization(embed_dim, normalization)

    def forward(self, h, aux_score):
        h_wave, aux_score = self.synth_att(h, aux_score)
        h = self.norm1(h + h_wave)
        h = self.norm2(h + self.ff2(torch.relu(self.ff1(h))))
        return h, aux_score


class N2SEncoder(nn.Module):
    """A two-layer MLP on the coordinates, the positional compatibility
    scores (``pos_net``) and the Synth-Attention stack."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, num_layers: int = 3,
                 feedforward_hidden: int = 128, normalization: str = "layer",
                 pos_type: str = "CPE"):
        super().__init__()
        self.num_layers = num_layers
        self.init_embed_0 = nn.Linear(2, embed_dim // 2)
        self.init_embed_1 = nn.Linear(embed_dim // 2, embed_dim)
        self.pos_embedding = pos_init_embedding(pos_type, embed_dim)
        self.pos_net = MultiHeadCompat(embed_dim, num_heads)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", N2SEncoderLayer(embed_dim, num_heads,
                                                         feedforward_hidden, normalization))

    def forward(self, state) -> torch.Tensor:
        h = self.init_embed_1(torch.relu(self.init_embed_0(state.locs)))
        aux = self.pos_net(self.pos_embedding(state))
        for i in range(self.num_layers):
            h, aux = getattr(self, f"layer_{i}")(h, aux)
        return h
