"""A2C: REINFORCE with a learned critic as its baseline (counterpart of
`rl4co_tpu/rl/a2c.py`).

The loss is REINFORCE's with the advantage ``reward − V(instance)``, plus
the critic's mean squared error. The optimiser clips the gradient of the
policy and the critic together by global norm (REINFORCE's 1.0), then takes
an Adam step with a learning rate per branch (``critic_lr``, default the
policy's), as the JAX package's `optax.multi_transform` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import (
    ConstructivePolicy,
    instances_to_device,
)
from rl4co_tpu_torch.rl.critic import CriticNetwork, WithCritic, critic_for
from rl4co_tpu_torch.rl.reinforce import ConstructiveAlgorithm
from rl4co_tpu_torch.utils.optim import Optimizer


class A2C(WithCritic, ConstructiveAlgorithm):
    def __init__(
        self,
        env: Env,
        policy: ConstructivePolicy,
        critic: Optional[CriticNetwork] = None,
        critic_lr: Optional[float] = None,
        train_spec: DecodeSpec = DecodeSpec(kind="sampling"),
        val_spec: DecodeSpec = DecodeSpec(kind="greedy"),
        lr: float = 1e-4,
        grad_clip: Optional[float] = 1.0,
    ):
        super().__init__(env, policy, train_spec, val_spec)
        self.critic = critic if critic is not None else critic_for(policy, self.device)
        adam = torch.optim.Adam([
            {"params": list(policy.parameters()), "lr": lr},
            {"params": list(self.critic.parameters()), "lr": critic_lr or lr}])
        self.optimizer = Optimizer(adam, None, grad_clip)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """The actor-critic loss of the live policy and critic on
        ``instances``; records the graph. Returns ``(loss, (metrics, rollout
        output))``, the metrics detached."""
        instances = instances_to_device(instances, self.device)
        out = self.train_rollout(instances, replay_actions)
        value = self.critic(instances)
        advantage = out.reward - value.detach()
        reinforce_loss = -(advantage * out.log_likelihood).mean()
        bl_loss = (value - out.reward).square().mean()
        loss = reinforce_loss + bl_loss
        metrics = {"loss": loss, "reinforce_loss": reinforce_loss, "bl_loss": bl_loss,
                   "reward": out.reward.mean(), "bl_val": value.mean(),
                   "entropy": out.entropy.mean()}
        return loss, ({k: v.detach() for k, v in metrics.items()}, out)

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None) -> dict:
        """One optimisation step on ``instances``; the metrics as tensors on
        the device."""
        self.optimizer.zero_grad()
        loss, (metrics, _) = self.loss(instances, replay_actions)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return metrics
