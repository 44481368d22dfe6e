"""Graph attention encoder stack (counterpart of
`rl4co_tpu/models/nn/graph/attnnet.py`).

Kool et al. (2019) transformer encoder, post-norm: per layer,
``h = Norm(x + MHA(x)); out = Norm(h + FFN(h))``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import MultiHeadAttention
from rl4co_tpu_torch.models.nn.ops import Normalization, TransformerFFN


class MultiHeadAttentionLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 8,
                 feedforward_hidden: int = 512, normalization: str = "batch"):
        super().__init__()
        self.mha = MultiHeadAttention(embed_dim, num_heads)
        self.norm1 = Normalization(embed_dim, normalization)
        self.ffn = TransformerFFN(embed_dim, feedforward_hidden)
        self.norm2 = Normalization(embed_dim, normalization)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x + self.mha(x, mask))
        return self.norm2(h + self.ffn(h))


class GraphAttentionNetwork(nn.Module):
    """``num_layers`` encoder layers named ``layer_0 … layer_{n-1}``."""

    def __init__(self, embed_dim: int, num_heads: int = 8, num_layers: int = 3,
                 normalization: str = "batch", feedforward_hidden: int = 512):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", MultiHeadAttentionLayer(
                embed_dim, num_heads, feedforward_hidden=feedforward_hidden,
                normalization=normalization,
            ))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x
