"""HAM, the Heterogeneous Attention Model for PDP (Li et al. 2021;
counterpart of `rl4co_tpu/models/zoo/ham.py`).

The encoder's self-attention gains six relation channels (pickup to its
delivery, to every pickup, to every delivery; delivery to its pickup, to
every delivery, to every pickup), appended as extra key columns of one
extended softmax. The decoder is AM's on PDP's context, through the
single-query pointer kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import _merge_heads, _split_heads
from rl4co_tpu_torch.models.nn.ops import Normalization, TransformerFFN
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy

NEG = -1e9


class HeterogeneousMHA(nn.Module):
    """Extended-softmax heterogeneous attention over nodes laid out as
    ``[depot, n pickups, n deliveries]`` (an odd graph size)."""

    def __init__(self, embed_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        for name in ("W_query", "W_key", "W_val", "W1_query", "W2_query", "W3_query",
                     "W4_query", "W5_query", "W6_query", "W_out"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim, bias=False))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, g, d = h.shape
        if g % 2 != 1:
            raise ValueError("HAM requires an odd graph size (depot + pairs)")
        n = (g - 1) // 2
        hn = self.num_heads
        hd = d // hn
        scale = 1.0 / math.sqrt(hd)

        def proj(x, name):
            return _split_heads(getattr(self, name)(x), hn)     # [B, H, S, hd]

        q, k, v = proj(h, "W_query"), proj(h, "W_key"), proj(h, "W_val")
        pick, delivery = h[:, 1 : n + 1], h[:, n + 1 :]
        k_pick, k_del = k[:, :, 1 : n + 1], k[:, :, n + 1 :]
        v_pick, v_del = v[:, :, 1 : n + 1], v[:, :, n + 1 :]
        q1, q2, q3 = (proj(pick, f"W{i}_query") for i in (1, 2, 3))
        q4, q5, q6 = (proj(delivery, f"W{i}_query") for i in (4, 5, 6))

        compat = torch.matmul(q, k.transpose(-1, -2)) * scale            # [B, H, G, G]

        def pad_rows(x, kind):
            """Per-pickup (or per-delivery) rows into all G rows, NEG elsewhere."""
            one = x.new_full((b, hn, 1) + x.shape[3:], NEG)
            other = x.new_full((b, hn, n) + x.shape[3:], NEG)
            parts = [one, x, other] if kind == "pick" else [one, other, x]
            return torch.cat(parts, dim=2)

        def mm(a, bb):
            return torch.matmul(a, bb.transpose(-1, -2)) * scale

        extended = torch.cat([
            compat,
            pad_rows((q1 * k_del).sum(-1)[..., None] * scale, "pick"),
            pad_rows(mm(q2, k_pick), "pick"),
            pad_rows(mm(q3, k_del), "pick"),
            pad_rows((q4 * k_pick).sum(-1)[..., None] * scale, "del"),
            pad_rows(mm(q5, k_del), "del"),
            pad_rows(mm(q6, k_pick), "del"),
        ], dim=-1)                                      # [B, H, G, G + 2 + 4n]
        attn = torch.softmax(extended, dim=-1)

        heads = torch.matmul(attn[..., :g], v)
        zeros1 = v.new_zeros((b, hn, 1, hd))
        zeros_n = v.new_zeros((b, hn, n, hd))
        v_add_del = torch.cat([zeros1, v_del, zeros_n], dim=2)
        v_add_pick = torch.cat([zeros1, zeros_n, v_pick], dim=2)
        i0 = g
        heads = heads + attn[..., i0][..., None] * v_add_del
        heads = heads + torch.matmul(attn[..., i0 + 1 : i0 + 1 + n], v_pick)
        heads = heads + torch.matmul(attn[..., i0 + 1 + n : i0 + 1 + 2 * n], v_del)
        i1 = i0 + 1 + 2 * n
        heads = heads + attn[..., i1][..., None] * v_add_pick
        heads = heads + torch.matmul(attn[..., i1 + 1 : i1 + 1 + n], v_del)
        heads = heads + torch.matmul(attn[..., i1 + 1 + n :], v_pick)
        return self.W_out(_merge_heads(heads))


class HAMEncoderLayer(nn.Module):
    """``Norm(x + HeteroMHA(x))``, then ``Norm(h + FFN(h))``."""

    def __init__(self, embed_dim: int, num_heads: int = 8, feedforward_hidden: int = 512,
                 normalization: str = "batch"):
        super().__init__()
        self.hetero_mha = HeterogeneousMHA(embed_dim, num_heads)
        self.norm1 = Normalization(embed_dim, normalization)
        self.ffn = TransformerFFN(embed_dim, feedforward_hidden)
        self.norm2 = Normalization(embed_dim, normalization)

    def forward(self, x):
        h = self.norm1(x + self.hetero_mha(x))
        return self.norm2(h + self.ffn(h))


class HAMPolicy(AttentionModelPolicy):
    """AM with the heterogeneous encoder (layers ``ham_layer_{i}``), on PDP."""

    def __init__(self, env_name: str = "pdp", **kwargs):
        super().__init__(env_name=env_name, **kwargs)

    def _make_encoder(self) -> None:
        for i in range(self.num_encoder_layers):
            self.add_module(f"ham_layer_{i}", HAMEncoderLayer(
                self.embed_dim, self.num_heads, feedforward_hidden=self.feedforward_hidden,
                normalization=self.normalization))
        return None

    def encode(self, instances) -> torch.Tensor:
        h = self.init_embed(instances)
        for i in range(self.num_encoder_layers):
            h = getattr(self, f"ham_layer_{i}")(h)
        return h


def HeterogeneousAttentionModel(env, policy: HAMPolicy | None = None,
                                policy_kwargs: dict | None = None, **kwargs):
    """HAM: `HAMPolicy` + REINFORCE (the rollout baseline by default).
    Returns a `REINFORCE` algorithm on the policy's device."""
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    if policy is None:
        policy = HAMPolicy(env_name=env.name, **(policy_kwargs or {}))
    return REINFORCE(env=env, policy=policy, **kwargs)


HeterogeneousAttentionModelPolicy = HAMPolicy
