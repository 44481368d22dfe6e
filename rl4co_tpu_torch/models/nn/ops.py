"""Basic neural ops (counterpart of `rl4co_tpu/models/nn/ops.py`).

Normalization semantics:

- ``batch``: normalize each channel over (batch, nodes) with affine params,
  **always with the statistics of the batch at hand**, computed in f32 with
  the biased variance and no running averages. `nn.BatchNorm1d` in eval mode
  would diverge from this. Consequence: an instance's encoding depends on
  which instances share its dispatch.
- ``instance``: normalize each channel over nodes, per instance, with affine.
- ``layer``: normalize over (nodes, channels) per instance, no affine.
- ``rms``: RMSNorm over channels with a scale.
"""

from __future__ import annotations

import torch
from torch import nn

EPSILON = 1e-5


class Normalization(nn.Module):
    def __init__(self, embed_dim: int, normalization: str = "batch"):
        super().__init__()
        if normalization not in (None, "none", "batch", "instance", "layer", "rms"):
            raise ValueError(f"Unknown normalization {normalization}")
        self.normalization = normalization
        if normalization in ("batch", "instance", "rms"):
            self.scale = nn.Parameter(torch.ones(embed_dim))
        if normalization in ("batch", "instance"):
            self.bias = nn.Parameter(torch.zeros(embed_dim))

    def _standardize(self, x: torch.Tensor, dims) -> torch.Tensor:
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + EPSILON)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalization in (None, "none"):
            return x
        in_dtype = x.dtype
        x = x.float()  # statistics in f32
        if self.normalization == "batch":
            y = self._standardize(x, tuple(range(x.ndim - 1))) * self.scale + self.bias
        elif self.normalization == "instance":
            y = self._standardize(x, (-2,)) * self.scale + self.bias
        elif self.normalization == "layer":
            y = self._standardize(x, (-2, -1))
        else:  # rms
            ms = x.square().mean(dim=-1, keepdim=True)
            y = x * torch.rsqrt(ms + EPSILON) * self.scale
        return y.to(in_dtype)


class TransformerFFN(nn.Module):
    """Feed-forward block used inside encoder layers: Linear, ReLU, Linear.
    The sub-module names are those of the JAX package's parameter tree
    (``Dense_0``, ``Dense_1``)."""

    def __init__(self, embed_dim: int, feedforward_hidden: int = 512):
        super().__init__()
        self.Dense_0 = nn.Linear(embed_dim, feedforward_hidden)
        self.Dense_1 = nn.Linear(feedforward_hidden, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x)))
