"""Attention Model policy (Kool et al. 2019), counterpart of
`rl4co_tpu/models/zoo/am.py`.

encoder = init embedding + graph attention stack; the decoder precomputes
glimpse K/V + logit K + graph context once per instance, then each decode
step is context embedding → pointer attention. The rollout loop itself lives
in `rl4co_tpu_torch/models/policies/constructive.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import PointerAttention
from rl4co_tpu_torch.models.nn.env_embeddings import (
    env_context_embedding,
    env_dynamic_embedding,
    env_init_embedding,
)
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import StaticEmbedding
from rl4co_tpu_torch.models.nn.graph.attnnet import GraphAttentionNetwork
from rl4co_tpu_torch.models.policies.constructive import (
    ConstructivePolicy,
    PrecomputedCache,
)
from rl4co_tpu_torch.utils.device import resolve_device


class AttentionModelPolicy(ConstructivePolicy):
    """AM encoder/decoder policy.

    Defaults are the published ones: embed 128, 3 encoder layers, 8 heads,
    ff 512, batch norm, graph context on. Sub-module names are those of the
    JAX package's parameter tree, so `rl4co_tpu_torch.convert` maps a tree
    onto this module by path. ``pointer_impl="kernel"`` sends every decode
    step through the fused CUDA kernel; ``"plain"`` is its plain composition
    (and the only one that takes ``mask_inner=False``).
    ``init_embedding_kwargs`` / ``context_embedding_kwargs`` go to the env's
    embedding modules as they are (``use_bias``, ``vehicle_capacity``,
    mPDP's ``num_agents``). Subclasses replace the embeddings (`_add_embedding`, as the
    multi-env policy does), the encoder (`_make_encoder`) or the pointer head
    (`_make_pointer`), as MVMoE and PolyNet do; a subclass that adds modules
    of its own moves them to `device`.
    """

    def __init__(
        self,
        env_name: str = "tsp",
        embed_dim: int = 128,
        num_encoder_layers: int = 3,
        num_heads: int = 8,
        feedforward_hidden: int = 512,
        normalization: str = "batch",
        use_graph_context: bool = True,
        mask_inner: bool = True,
        pointer_impl: str = "kernel",
        init_embedding_kwargs: dict | None = None,
        context_embedding_kwargs: dict | None = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.env_name = env_name
        self.embed_dim = embed_dim
        self.num_encoder_layers = num_encoder_layers
        self.num_heads = num_heads
        self.feedforward_hidden = feedforward_hidden
        self.normalization = normalization
        self.use_graph_context = use_graph_context
        self.mask_inner = mask_inner
        self.pointer_impl = pointer_impl
        self._add_embedding("init_embedding", env_init_embedding, init_embedding_kwargs)
        self.encoder_net = self._make_encoder()
        self._add_embedding("context_embedding", env_context_embedding,
                            context_embedding_kwargs)
        # SDVRP's remaining demands move K/V/logit keys at every step; every
        # other env's is the parameterless `StaticEmbedding`
        self.dynamic_embedding = env_dynamic_embedding(env_name, embed_dim)
        self.project_node_embeddings = nn.Linear(embed_dim, 3 * embed_dim, bias=False)
        # no graph context, no projection of it (the JAX tree has no such leaf)
        self.project_fixed_context = (
            nn.Linear(embed_dim, embed_dim, bias=False) if use_graph_context else None)
        self.pointer = self._make_pointer()
        self.to(device)

    def _add_embedding(self, name: str, make, kwargs: dict | None) -> None:
        """Register the env's embedding module ``name`` (``init_embedding``
        or ``context_embedding``), ``make(env_name, embed_dim, **kwargs)``;
        the multi-env policy registers one per env instead."""
        self.add_module(name, make(self.env_name, self.embed_dim, **(kwargs or {})))

    def _make_encoder(self) -> nn.Module | None:
        """The encoder stack `encode` runs on the initial embeddings."""
        return GraphAttentionNetwork(
            embed_dim=self.embed_dim,
            num_heads=self.num_heads,
            num_layers=self.num_encoder_layers,
            normalization=self.normalization,
            feedforward_hidden=self.feedforward_hidden,
        )

    def _make_pointer(self) -> nn.Module:
        """The pointer head `decode_step` calls; overridden by PolyNet and MVMoE."""
        return PointerAttention(self.embed_dim, self.num_heads, impl=self.pointer_impl,
                                mask_inner=self.mask_inner)

    def init_embed(self, instances) -> torch.Tensor:
        """The initial node embeddings, before the encoder (SymNCO's
        invariance loss reads them)."""
        return self.init_embedding(instances)

    def encode(self, instances) -> torch.Tensor:
        return self.encoder_net(self.init_embed(instances))

    def precompute(self, embeddings: torch.Tensor) -> PrecomputedCache:
        proj = self.project_node_embeddings(embeddings)
        # glimpse K, glimpse V, logit K, in that order; made contiguous once
        # here because every decode step hands them to the kernel
        glimpse_k, glimpse_v, logit_k = (
            t.contiguous() for t in proj.chunk(3, dim=-1)
        )
        if self.use_graph_context:
            graph_context = self.project_fixed_context(embeddings.mean(dim=-2))
        else:
            graph_context = 0.0
        return PrecomputedCache(
            node_embeddings=embeddings,
            graph_context=graph_context,
            glimpse_key=glimpse_k,
            glimpse_val=glimpse_v,
            logit_key=logit_k,
        )

    @property
    def has_dynamic_embedding(self) -> bool:
        return not isinstance(self.dynamic_embedding, StaticEmbedding)

    def decode_step(self, cache: PrecomputedCache, state, mask,
                    num_repeats: int = 1) -> torch.Tensor:
        """One decode step.

        With ``num_repeats == g > 1`` the cache stays *untiled* ``[B, ...]``
        while the state/mask are flat ``[g*B, ...]`` (repeat-major): the g
        starts/samples of an instance become a query axis sharing one K/V
        load. Logits go back flat ``[g*B, N]``. An env with a dynamic
        embedding decodes with ``num_repeats == 1`` on a cache tiled as its
        state is: this step's K/V/logit keys are the cache's plus the
        state's deltas, new tensors that the kernel takes as they are.
        """
        gk, gv, lk = cache.glimpse_key, cache.glimpse_val, cache.logit_key
        # the context embedding reads the untiled node embeddings for a flat
        # repeat-major state too (`gather_rows`)
        query = self.context_embedding(cache.node_embeddings, state)  # [g*B, D]
        if num_repeats == 1:
            if self.has_dynamic_embedding:
                dk, dv, dl = self.dynamic_embedding(state)
                gk, gv, lk = ((c + delta).contiguous()
                              for c, delta in ((gk, dk), (gv, dv), (lk, dl)))
            return self.pointer(query + cache.graph_context, gk, gv, lk, mask)

        if self.has_dynamic_embedding:
            raise ValueError("grouped decode needs static embeddings: an env with a dynamic "
                             "embedding decodes on a cache tiled per repeat")
        g = num_repeats
        b, n, d = cache.node_embeddings.shape
        if self.use_graph_context:
            query = query + cache.graph_context.repeat(g, 1)
        query_g = query.reshape(g, b, d).transpose(0, 1)         # [B, g, D]
        mask_g = mask.reshape(g, b, n).transpose(0, 1)           # [B, g, N]
        logits = self.pointer(query_g, gk, gv, lk, mask_g)       # [B, g, N]
        return logits.transpose(0, 1).reshape(g * b, n)


def AttentionModel(
    env,
    policy: AttentionModelPolicy | None = None,
    baseline="rollout",
    policy_kwargs: dict | None = None,
    **kwargs,
):
    """The Attention Model (Kool et al. 2019): AM policy + REINFORCE with a
    greedy rollout baseline. Convenience constructor; returns a `REINFORCE`
    algorithm. The policy is built on ``"cuda"`` unless
    ``policy_kwargs["device"]`` says otherwise, and the algorithm runs where
    its policy lives.
    """
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    if policy is None:
        policy = AttentionModelPolicy(env_name=env.name, **(policy_kwargs or {}))
    return REINFORCE(env=env, policy=policy, baseline=baseline, **kwargs)


def AMPPO(
    env,
    policy: AttentionModelPolicy | None = None,
    policy_kwargs: dict | None = None,
    **kwargs,
):
    """The AM policy trained with PPO and a critic mirroring its encoder.
    Convenience constructor; returns a `PPO` algorithm, on the policy's
    device (``"cuda"`` unless ``policy_kwargs["device"]`` says otherwise)."""
    from rl4co_tpu_torch.rl.ppo import PPO

    if policy is None:
        policy = AttentionModelPolicy(env_name=env.name, **(policy_kwargs or {}))
    return PPO(env=env, policy=policy, **kwargs)
