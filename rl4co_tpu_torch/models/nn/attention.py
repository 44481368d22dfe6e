"""Attention building blocks (counterpart of `rl4co_tpu/models/nn/attention.py`).

The encoder's attention is written out as batched matrix products. The
single-query and grouped pointer step of the decoder goes through the fused
CUDA kernel in `rl4co_tpu_torch/ops/pointer_kernel.py` (``impl="kernel"``,
the default); its plain composition (``impl="plain"``) exists for the tests
and for comparisons. `pointer_logits` is the functional core of the pointer
head with a caller's own output projection: the JAX package's XLA path,
which PolyNet and MVMoE use, and the pointer's options that the kernel does
not take (an output bias, an unmasked glimpse).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def pointer_logits(
    query: torch.Tensor,      # [B, L, D] L context queries per instance
    glimpse_k: torch.Tensor,  # [B, N, D]
    glimpse_v: torch.Tensor,  # [B, N, D]
    logit_k: torch.Tensor,    # [B, N, D]
    mask: torch.Tensor,       # [B, L, N] True = feasible
    num_heads: int,
    project_out: Callable[[torch.Tensor], torch.Tensor],  # [B, L, D] -> [B, L, D]
    mask_inner: bool = True,
) -> torch.Tensor:
    """Functional core of the pointer head: the masked multi-head glimpse of
    the L queries over glimpse K/V (masked scores *set* to -1e9; no mask at
    all with ``mask_inner=False``), ``project_out`` of the merged heads, then
    logits = glimpse · logit_k^T / sqrt(D), ``[B, L, N]``. The L queries of an
    instance share its K/V."""
    d = glimpse_k.shape[-1]
    q = _split_heads(query, num_heads)                   # [B, H, L, Dh]
    k = _split_heads(glimpse_k, num_heads)               # [B, H, N, Dh]
    v = _split_heads(glimpse_v, num_heads)
    inner_mask = mask[:, None, :, :] if mask_inner else None
    heads = scaled_dot_product_attention(q, k, v, inner_mask)  # [B, H, L, Dh]
    glimpse = project_out(_merge_heads(heads))                 # [B, L, D]
    return torch.matmul(glimpse, logit_k.transpose(-1, -2)) / math.sqrt(d)


def single_query(pointer_fn, query, glimpse_k, glimpse_v, logit_k, mask):
    """``pointer_fn`` over ``[B, L, D]`` queries and ``[B, L, N]`` masks,
    called with a ``[B, D]`` query and ``[B, N]`` mask as L = 1."""
    if query.ndim == 3:
        return pointer_fn(query, glimpse_k, glimpse_v, logit_k, mask)
    return pointer_fn(query[:, None], glimpse_k, glimpse_v, logit_k, mask[:, None])[:, 0]


class PointerAttention(nn.Module):
    """AM decoder pointer head: masked multi-head glimpse over the cached
    K/V, output projection, then logits = glimpse · logit_k^T / sqrt(D).

    The query is ``[B, D]`` or ``[B, L, D]``; the L axis carries multistart
    starts / sampling repeats, which share one instance's K/V instead of
    tiling it per start. ``impl="kernel"`` (default, the only value the main
    path uses) sends the step through the fused kernel: one launch per decode
    step. ``impl="plain"`` computes the kernels' plain version, for the tests
    and for comparisons. ``project_out_kernel`` is ``[D, D]`` and used as
    ``x @ W``. The kernel takes neither an output bias (``out_bias=True``
    adds ``project_out_bias``) nor an unmasked glimpse (``mask_inner=False``):
    with ``impl="kernel"`` they raise, as the JAX package's Pallas path
    refuses them; with ``impl="plain"`` they compute through `pointer_logits`.
    """

    def __init__(self, embed_dim: int, num_heads: int = 8, impl: str = "kernel",
                 mask_inner: bool = True, out_bias: bool = False):
        super().__init__()
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        if impl == "kernel" and (out_bias or not mask_inner):
            raise ValueError("the pointer kernel takes no output bias and always masks "
                             "the glimpse: out_bias=True or mask_inner=False needs "
                             "impl='plain'")
        self.num_heads = num_heads
        self.impl = impl
        self.mask_inner = mask_inner
        self.project_out_kernel = nn.Parameter(torch.empty(embed_dim, embed_dim))
        nn.init.normal_(self.project_out_kernel, std=embed_dim ** -0.5)
        self.project_out_bias = nn.Parameter(torch.zeros(embed_dim)) if out_bias else None

    def forward(
        self,
        query: torch.Tensor,      # [B, D] or [B, L, D]
        glimpse_k: torch.Tensor,  # [B, N, D]
        glimpse_v: torch.Tensor,
        logit_k: torch.Tensor,
        mask: torch.Tensor,       # [B, N] or [B, L, N], True = feasible
    ) -> torch.Tensor:
        if self.project_out_bias is not None or not self.mask_inner:
            def project_out(x):
                y = x @ self.project_out_kernel
                return y if self.project_out_bias is None else y + self.project_out_bias

            def step(*args):
                return pointer_logits(*args, num_heads=self.num_heads, project_out=project_out,
                                      mask_inner=self.mask_inner)

            return single_query(step, query, glimpse_k, glimpse_v, logit_k, mask)
        # the caches must already be contiguous (the wrapper refuses a
        # strided one: a copy here would be paid at every decode step)
        step = fused_pointer_logits if self.impl == "kernel" else pointer_logits_plain
        return step(
            query.contiguous(), glimpse_k, glimpse_v, logit_k,
            mask_to_neg_bias(mask).contiguous(),
            self.project_out_kernel, self.num_heads,
        )
