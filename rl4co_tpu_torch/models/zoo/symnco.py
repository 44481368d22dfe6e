"""SymNCO (Kim et al. 2022): REINFORCE that exploits symmetries
(counterpart of `rl4co_tpu/models/zoo/symnco.py`).

- The policy is AM with a projection head over the initial embeddings.
- The loss trains on ``num_augment`` symmetric copies of each instance
  (copy 0 untransformed) and, with ``num_starts > 1``, on multistart
  sampling. It sums three terms, gated as the JAX package gates them:
  `problem_symmetricity_loss` (baseline: the mean over the augmentations)
  when there are starts, ``beta`` × `solution_symmetricity_loss` (baseline:
  the mean over the starts) when there are augmentations, and ``alpha`` ×
  `invariance_loss` of the projected initial embeddings when there are
  augmentations and a projection head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.data.transforms import augment_instances
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import instances_to_device
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy
from rl4co_tpu_torch.rl.baselines import NoBaseline
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.ops import unbatchify


class ProjectionHead(nn.Module):
    """Dense, ReLU, Dense; the names are those of the JAX package's
    ``nn.Sequential`` (``layers_0``, ``layers_2``)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.layers_0 = nn.Linear(embed_dim, embed_dim)
        self.layers_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(torch.relu(self.layers_0(x)))


class SymNCOPolicy(AttentionModelPolicy):
    """AM policy with a projection head (``use_projection_head``)."""

    def __init__(self, *args, use_projection_head: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_projection_head = use_projection_head
        if use_projection_head:
            self.projection_head = ProjectionHead(self.embed_dim).to(
                self.project_node_embeddings.weight.device)

    def project(self, init_embeds: torch.Tensor) -> torch.Tensor:
        return self.projection_head(init_embeds)


def problem_symmetricity_loss(reward: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """Advantage against the mean over the augmentation axis; ``[B, A, S]``."""
    advantage = reward - reward.mean(dim=1, keepdim=True)
    return -(advantage * ll).mean()


def solution_symmetricity_loss(reward: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """Advantage against the mean over the start axis; ``[B, A, S]``."""
    advantage = reward - reward.mean(dim=-1, keepdim=True)
    return -(advantage * ll).mean()


def invariance_loss(proj: torch.Tensor, num_augment: int) -> torch.Tensor:
    """The cosine similarity of each augmented copy's projections to copy
    0's, summed over the copies, meaned over instances and nodes;
    ``proj [A*B, N, D]`` repeat-major."""
    pe = unbatchify(proj, num_augment)  # [B, A, N, D]
    ref = pe[:, 0]
    sims = []
    for i in range(1, num_augment):
        num = (ref * pe[:, i]).sum(-1)
        den = (torch.linalg.vector_norm(ref, dim=-1)
               * torch.linalg.vector_norm(pe[:, i], dim=-1) + 1e-8)
        sims.append(num / den)
    return sum(sims).mean()


class SymNCO(REINFORCE):
    """SymNCO algorithm. The baseline is `NoBaseline` whatever is passed (the
    loss takes its own); with ``num_starts > 1`` the train spec becomes
    multistart sampling over that many starts. Without a ``policy``,
    `SymNCOPolicy(env.name, **policy_kwargs)`."""

    def __init__(self, env: Env, policy: Optional[SymNCOPolicy] = None, num_augment: int = 4,
                 augment_fn: str = "symmetric", alpha: float = 0.2, beta: float = 1.0,
                 num_starts: int = 0, policy_kwargs: Optional[dict] = None,
                 train_spec: DecodeSpec = DecodeSpec(kind="sampling"), **kwargs):
        if policy is None:
            policy = SymNCOPolicy(env_name=env.name, **(policy_kwargs or {}))
        if num_starts > 1:
            train_spec = dataclasses.replace(train_spec, kind="sampling", multistart=True,
                                             num_starts=num_starts)
        self.num_augment, self.augment_fn = num_augment, augment_fn
        self.alpha, self.beta, self.num_starts = alpha, beta, num_starts
        super().__init__(env, policy, baseline=NoBaseline(), train_spec=train_spec, **kwargs)

    def augment(self, instances: dict) -> dict:
        """The ``num_augment`` copies of ``instances`` (on the device) the
        loss trains on, drawn from the algorithm's generator."""
        if self.num_augment <= 1:
            return instances
        return augment_instances(instances, self.num_augment, self.augment_fn,
                                 generator=self.generator)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """SymNCO's loss on ``instances``; with ``replay_actions`` ``[S*A*B, T]``
        the rollout replays them. Returns ``(loss, (metrics, rollout output))``."""
        a, s = self.num_augment, max(self.num_starts, 1)
        instances = self.augment(instances_to_device(instances, self.device))
        out = self.train_rollout(instances, replay_actions)
        reward = unbatchify(unbatchify(out.reward, s), a)              # [B, A, S]
        ll = unbatchify(unbatchify(out.log_likelihood, s), a)          # [B, A, S]
        zero = torch.zeros((), device=self.device)
        loss_ps = problem_symmetricity_loss(reward, ll) if s > 1 else zero
        loss_ss = solution_symmetricity_loss(reward, ll) if a > 1 else zero
        if a > 1 and self.policy.use_projection_head:
            loss_inv = invariance_loss(self.policy.project(self.policy.init_embed(instances)), a)
        else:
            loss_inv = zero
        loss = loss_ps + self.beta * loss_ss + self.alpha * loss_inv
        metrics = {
            "loss": loss.detach(),
            "loss_ps": loss_ps.detach(),
            "loss_ss": loss_ss.detach(),
            "loss_inv": loss_inv.detach(),
            "reward": reward.mean(),
            "entropy": out.entropy.detach().mean(),
        }
        return loss, (metrics, out)
