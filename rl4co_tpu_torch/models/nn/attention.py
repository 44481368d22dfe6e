"""Attention building blocks (counterpart of `rl4co_tpu/models/nn/attention.py`).

The encoder's attention is written out as batched matrix products. The
single-query and grouped pointer step of the decoder goes through the fused
CUDA kernel in `rl4co_tpu_torch/ops/pointer_kernel.py` (``impl="kernel"``,
the default); its plain composition (``impl="plain"``) exists for the tests
and for comparisons.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.ops.pointer_kernel import (
    fused_pointer_logits,
    mask_to_neg_bias,
    pointer_logits_plain,
)

MASK_VALUE = -1e9  # large-negative instead of -inf: keeps softmax NaN-free


def scaled_dot_product_attention(
    q: torch.Tensor,  # [..., H, L, Dh]
    k: torch.Tensor,  # [..., H, S, Dh]
    v: torch.Tensor,  # [..., H, S, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [..., H, L, S]; True = attend
) -> torch.Tensor:
    """Written out rather than `F.scaled_dot_product_attention`: masked
    scores are *set* to -1e9 (not -inf), as in the JAX package."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., S, H*Dh] -> [..., H, S, Dh]"""
    *lead, s, d = x.shape
    return x.reshape(*lead, s, num_heads, d // num_heads).transpose(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, Dh] -> [..., S, H*Dh]"""
    x = x.transpose(-3, -2)
    *lead, s, h, dh = x.shape
    return x.reshape(*lead, s, h * dh)


class MultiHeadAttention(nn.Module):
    """Self-attention MHA: one ``Wqkv`` [D -> 3D] split into q, k, v in that
    order, and ``out_proj``, both with bias."""

    def __init__(self, embed_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.Wqkv(x).chunk(3, dim=-1)
        q = _split_heads(q, self.num_heads)
        k = _split_heads(k, self.num_heads)
        v = _split_heads(v, self.num_heads)
        if mask is not None and mask.ndim == x.ndim - 1:
            # [B, S] key-padding mask -> [B, 1, 1, S]
            mask = mask[..., None, None, :]
        out = scaled_dot_product_attention(q, k, v, mask)
        return self.out_proj(_merge_heads(out))


class PointerAttention(nn.Module):
    """AM decoder pointer head: masked multi-head glimpse over the cached
    K/V, output projection, then logits = glimpse · logit_k^T / sqrt(D).

    The query is ``[B, D]`` or ``[B, L, D]``; the L axis carries multistart
    starts / sampling repeats, which share one instance's K/V instead of
    tiling it per start. ``impl="kernel"`` (default, the only value the main
    path uses) sends the step through the fused kernel: one launch per decode
    step. ``impl="plain"`` computes the kernels' plain version, for the tests
    and for comparisons. ``project_out_kernel`` is ``[D, D]`` and used as
    ``x @ W`` (no transpose, no bias); the mask always applies to the glimpse.
    """

    def __init__(self, embed_dim: int, num_heads: int = 8, impl: str = "kernel"):
        super().__init__()
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.num_heads = num_heads
        self.impl = impl
        self.project_out_kernel = nn.Parameter(torch.empty(embed_dim, embed_dim))
        nn.init.normal_(self.project_out_kernel, std=embed_dim ** -0.5)

    def forward(
        self,
        query: torch.Tensor,      # [B, D] or [B, L, D]
        glimpse_k: torch.Tensor,  # [B, N, D]
        glimpse_v: torch.Tensor,
        logit_k: torch.Tensor,
        mask: torch.Tensor,       # [B, N] or [B, L, N], True = feasible
    ) -> torch.Tensor:
        # the caches must already be contiguous (the wrapper refuses a
        # strided one: a copy here would be paid at every decode step)
        step = fused_pointer_logits if self.impl == "kernel" else pointer_logits_plain
        return step(
            query.contiguous(), glimpse_k, glimpse_v, logit_k,
            mask_to_neg_bias(mask).contiguous(),
            self.project_out_kernel, self.num_heads,
        )
