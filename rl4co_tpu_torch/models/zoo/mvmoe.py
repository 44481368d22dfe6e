"""MVMoE (Zhou et al. 2024): the AM/POMO policy with Mixture-of-Experts
feed-forwards in the encoder and an MoE output projection in the pointer
head (counterpart of `rl4co_tpu/models/zoo/mvmoe.py`).

The pointer head calls the functional `pointer_logits` with the MoE as its
projection, as the JAX package does: the fused pointer kernel computes a
single ``[D, D]`` projection and has no place for it, so no decode step of
MVMoE launches a kernel. The experts are plain batched products
(`rl4co_tpu_torch/models/nn/moe.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import MultiHeadAttention, pointer_logits, single_query
from rl4co_tpu_torch.models.nn.moe import MoE
from rl4co_tpu_torch.models.nn.ops import Normalization
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy


class MoEAttentionLayer(nn.Module):
    """Post-norm encoder layer whose feed-forward is an MoE:
    ``h = Norm(x + MHA(x)); out = Norm(h + MoE(h))``."""

    def __init__(self, embed_dim: int, num_heads: int = 8, feedforward_hidden: int = 512,
                 normalization: str = "instance", num_experts: int = 4, topk: int = 2):
        super().__init__()
        self.mha = MultiHeadAttention(embed_dim, num_heads)
        self.norm1 = Normalization(embed_dim, normalization)
        self.moe_ffn = MoE(embed_dim, embed_dim, (feedforward_hidden,),
                           num_experts=num_experts, k=topk)
        self.norm2 = Normalization(embed_dim, normalization)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x + self.mha(x, mask))
        return self.norm2(h + self.moe_ffn(h))


class PointerAttnMoE(nn.Module):
    """Pointer head whose output projection is an MoE (``project_out_moe``)."""

    def __init__(self, embed_dim: int, num_heads: int = 8, mask_inner: bool = True,
                 num_experts: int = 4, topk: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.mask_inner = mask_inner
        self.project_out_moe = MoE(embed_dim, embed_dim, (), num_experts=num_experts, k=topk)

    def forward(self, query, glimpse_k, glimpse_v, logit_k, mask):
        def step(*args):
            return pointer_logits(*args, num_heads=self.num_heads,
                                  project_out=self.project_out_moe, mask_inner=self.mask_inner)

        return single_query(step, query, glimpse_k, glimpse_v, logit_k, mask)


class MVMoEPolicy(AttentionModelPolicy):
    """AM policy whose encoder layers are `MoEAttentionLayer`s named
    ``moe_layer_{i}`` and whose pointer is `PointerAttnMoE`. It owns no
    ``encoder_net``: the JAX package builds AM's and never calls it, so its
    parameter tree holds none. ``pointer_impl`` does not apply."""

    def __init__(self, *args, num_experts: int = 4, moe_topk: int = 2, **kwargs):
        self.num_experts = num_experts
        self.moe_topk = moe_topk
        super().__init__(*args, **kwargs)

    def _make_encoder(self) -> None:
        for i in range(self.num_encoder_layers):
            self.add_module(f"moe_layer_{i}", MoEAttentionLayer(
                self.embed_dim, self.num_heads, feedforward_hidden=self.feedforward_hidden,
                normalization=self.normalization, num_experts=self.num_experts,
                topk=self.moe_topk))
        return None

    def _make_pointer(self) -> nn.Module:
        return PointerAttnMoE(self.embed_dim, self.num_heads, mask_inner=self.mask_inner,
                              num_experts=self.num_experts, topk=self.moe_topk)

    def encode(self, instances) -> torch.Tensor:
        h = self.init_embed(instances)
        for i in range(self.num_encoder_layers):
            h = getattr(self, f"moe_layer_{i}")(h)
        return h


def MVMoE_AM(env, policy: MVMoEPolicy | None = None, policy_kwargs: dict | None = None,
             **kwargs):
    """MVMoE trained as AM: the MoE policy with REINFORCE and its default
    greedy rollout baseline. Returns a `REINFORCE` algorithm."""
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    if policy is None:
        policy = MVMoEPolicy(env_name=env.name, **(policy_kwargs or {}))
    return REINFORCE(env=env, policy=policy, **kwargs)


def MVMoE_POMO(env, policy: MVMoEPolicy | None = None, policy_kwargs: dict | None = None,
               **kwargs):
    """MVMoE trained as POMO: the MoE policy with POMO's deviations (6
    layers, instance norm, no graph context) and multistart REINFORCE with
    the shared baseline. Returns a `POMO` algorithm."""
    from rl4co_tpu_torch.models.zoo.pomo import POMO

    if policy is None:
        pk = dict(num_encoder_layers=6, normalization="instance", use_graph_context=False)
        pk.update(policy_kwargs or {})
        policy = MVMoEPolicy(env_name=env.name, **pk)
    return POMO(env=env, policy=policy, **kwargs)
