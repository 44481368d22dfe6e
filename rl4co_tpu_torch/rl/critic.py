"""Critic network (counterpart of `rl4co_tpu/rl/critic.py`).

The actor's encoder architecture (the env's init embedding, then the graph
attention stack) under a value head, Dense(hidden_dim) → ReLU → Dense(1),
meaned over all the nodes, the depot included: ``[B]``. The sub-modules
carry the Flax module's automatic names (``TSPInitEmbedding_0``,
``GraphAttentionNetwork_0``, ``Dense_0``, ``Dense_1``), so that
`rl4co_tpu_torch.convert.load_params` takes the JAX critic's tree.
"""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.env_embeddings import env_init_embedding
from rl4co_tpu_torch.models.nn.graph.attnnet import GraphAttentionNetwork
from rl4co_tpu_torch.utils.device import resolve_device


class CriticNetwork(nn.Module):
    def __init__(
        self,
        env_name: str = "tsp",
        embed_dim: int = 128,
        num_encoder_layers: int = 3,
        num_heads: int = 8,
        feedforward_hidden: int = 512,
        normalization: str = "batch",
        hidden_dim: int = 256,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        init = env_init_embedding(env_name, embed_dim)
        self.init_name = f"{type(init).__name__}_0"
        self.add_module(self.init_name, init)
        self.GraphAttentionNetwork_0 = GraphAttentionNetwork(
            embed_dim=embed_dim, num_heads=num_heads, num_layers=num_encoder_layers,
            normalization=normalization, feedforward_hidden=feedforward_hidden)
        self.Dense_0 = nn.Linear(embed_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)
        self.to(device)

    def forward(self, instances) -> torch.Tensor:
        h = self.GraphAttentionNetwork_0(getattr(self, self.init_name)(instances))
        v = self.Dense_1(torch.relu(self.Dense_0(h)))     # [B, N, 1]
        return v.mean(dim=-2)[..., 0]                     # [B]


def critic_for(policy, device) -> CriticNetwork:
    """A critic mirroring ``policy``'s encoder (its env, widths and norm),
    on ``device``."""
    return CriticNetwork(env_name=policy.env_name, embed_dim=policy.embed_dim,
                         num_encoder_layers=policy.num_encoder_layers,
                         num_heads=policy.num_heads,
                         feedforward_hidden=policy.feedforward_hidden,
                         normalization=policy.normalization, device=device)


class WithCritic:
    """The checkpoint and epoch-end hook of an algorithm that trains a
    critic beside its policy (PPO, A2C): the policy under ``"policy"``,
    where the trainer and the eval command line read it, the critic beside
    it, the optimiser and the step count; no baseline state."""

    def epoch_end(self, host: dict) -> dict:
        return host

    def state_dict(self) -> dict:
        return {"policy": self.policy.state_dict(), "critic": self.critic.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.critic.load_state_dict(state["critic"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
