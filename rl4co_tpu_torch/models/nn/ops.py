"""Basic neural ops (counterpart of `rl4co_tpu/models/nn/ops.py`).

Normalization semantics:

- ``batch``: normalize each channel over (batch, nodes) with affine params,
  **always with the statistics of the batch at hand**, computed in f32 with
  the biased variance and no running averages. `nn.BatchNorm1d` in eval mode
  would diverge from this. Consequence: an instance's encoding depends on
  which instances share its dispatch. In a data-parallel train step
  (`rl4co_tpu_torch.parallel.mesh.sharded`) the batch is the global one: the
  mean and variance come from sums all-reduced over the ranks, and so does
  their backward.
- ``instance``: normalize each channel over nodes, per instance, with affine.
- ``layer``: normalize over (nodes, channels) per instance, no affine.
- ``rms``: RMSNorm over channels with a scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rl4co_tpu_torch.parallel.mesh import active_shard, all_reduce_sum, global_count

EPSILON = 1e-5

# the JAX package's activation table (its ``gelu`` is the tanh approximation)
ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


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

    @staticmethod
    def _standardize_global(x: torch.Tensor, dims) -> torch.Tensor:
        """`_standardize` over every rank's rows: the sum, then the sum of
        squared deviations, each all-reduced."""
        count = global_count(x.numel() // x.shape[-1])
        mean = all_reduce_sum(x.sum(dim=dims, keepdim=True)) / count
        var = all_reduce_sum((x - mean).square().sum(dim=dims, keepdim=True)) / count
        return (x - mean) * torch.rsqrt(var + EPSILON)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalization in (None, "none"):
            return x
        in_dtype = x.dtype
        x = x.float()  # statistics in f32
        if self.normalization == "batch":
            dims = tuple(range(x.ndim - 1))
            if active_shard() is None:
                x = self._standardize(x, dims)
            else:
                x = self._standardize_global(x, dims)
            y = x * self.scale + self.bias
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


class MLP(nn.Module):
    """Linear layers with ``hidden_act`` between them and ``out_act`` at the
    end; the layers carry Flax's automatic names ``Dense_0``, ``Dense_1``, ..."""

    def __init__(self, input_dim: int, output_dim: int, num_neurons=(),
                 hidden_act: str = "relu", out_act: str = "identity", use_bias: bool = True):
        super().__init__()
        dims = [input_dim, *num_neurons, output_dim]
        for i in range(len(dims) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1], bias=use_bias))
        self.num_layers = len(dims) - 1
        self.hidden_act = ACTIVATIONS[hidden_act.lower()]
        self.out_act = ACTIVATIONS[out_act.lower()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = self.hidden_act(x) if i < self.num_layers - 1 else self.out_act(x)
        return x


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding, no parameters: ``x + pe[positions]``
    (``positions [..., S]`` integer), or ``x + pe[:S]`` along the second to
    last axis without them. The table is the JAX package's: f32 sines on the
    even channels and cosines on the odd ones of ``pos * div``."""

    def __init__(self, embed_dim: int, max_len: int = 1000):
        super().__init__()
        self.embed_dim, self.max_len = embed_dim, max_len

    def table(self, device) -> torch.Tensor:
        d = self.embed_dim
        pos = torch.arange(self.max_len, device=device, dtype=torch.float32)[:, None]
        log10k = torch.log(torch.tensor(10000.0, device=device))
        div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                        * (-log10k / d))
        pe = torch.zeros((self.max_len, d), device=device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return pe

    def forward(self, x: torch.Tensor, positions=None) -> torch.Tensor:
        pe = self.table(x.device)
        if positions is None:
            return x + pe[: x.shape[-2]]
        return x + pe[positions.long()]
