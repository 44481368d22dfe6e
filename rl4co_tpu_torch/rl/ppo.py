"""PPO for the single-step constructive MDP (counterpart of
`rl4co_tpu/rl/ppo.py`).

One rollout is one action: the advantage is ``reward − V(instance)``, with
no GAE. A train step takes one sampling rollout of the old policy without a
graph, then ``ppo_epochs`` passes over shuffled minibatches: each minibatch
replays its actions through ``rollout(kind="evaluate")`` under autograd (the
single-query kernel's forward, and its recompute backward, at every decode
step) and takes one Adam step over the policy and the critic together, after
clipping their joint gradient by global norm as optax does.

As in the JAX package, each minibatch's rollout and critic normalise over
that minibatch (batch norm), so the ratio is not 1 at the first minibatch:
the old log-likelihoods came from the whole batch.

Draws: ``update(instances, replay_actions, minibatches)`` takes the old
rollout's actions and the ``[ppo_epochs · num_mb, mb]`` index blocks as
tensors, so that a test can hand in the JAX package's; by default both come
from the algorithm's generator, the actions first.
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
from rl4co_tpu_torch.utils.optim import get_optimizer


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Elementwise, as `optax.huber_loss` writes it."""
    abs_errors = (predictions - targets).abs()
    quadratic = abs_errors.clamp(max=delta)
    return 0.5 * quadratic.square() + delta * (abs_errors - quadratic)


class PPO(WithCritic, ConstructiveAlgorithm):
    """Defaults are the JAX package's: clip 0.2, 2 epochs, minibatches of a
    quarter of the batch, value loss weight 0.5, no entropy bonus, gradients
    clipped to global norm 0.5, Adam at 1e-4. Without a ``critic`` one is
    built mirroring the policy's encoder, on the policy's device."""

    def __init__(
        self,
        env: Env,
        policy: ConstructivePolicy,
        critic: Optional[CriticNetwork] = None,
        clip_range: float = 0.2,
        ppo_epochs: int = 2,
        mini_batch_fraction: float = 0.25,
        vf_lambda: float = 0.5,
        entropy_lambda: float = 0.0,
        normalize_adv: bool = False,
        max_grad_norm: float = 0.5,
        lr: float = 1e-4,
        train_spec: DecodeSpec = DecodeSpec(kind="sampling"),
        val_spec: DecodeSpec = DecodeSpec(kind="greedy"),
    ):
        super().__init__(env, policy, train_spec, val_spec)
        self.critic = critic if critic is not None else critic_for(policy, self.device)
        self.clip_range = clip_range
        self.ppo_epochs = ppo_epochs
        self.mini_batch_fraction = mini_batch_fraction
        self.vf_lambda = vf_lambda
        self.entropy_lambda = entropy_lambda
        self.normalize_adv = normalize_adv
        self.optimizer = get_optimizer([*policy.parameters(), *self.critic.parameters()],
                                       "adam", lr, grad_clip=max_grad_norm)

    def minibatch_shape(self, batch_size: int) -> tuple:
        """``(num_mb, mb_size)``: the JAX package's
        ``mb = max(1, int(B · fraction))`` and ``num_mb = B // mb``."""
        mb_size = max(1, int(batch_size * self.mini_batch_fraction))
        return batch_size // mb_size, mb_size

    def draw_minibatches(self, batch_size: int) -> torch.Tensor:
        """``[ppo_epochs · num_mb, mb]`` indices: per epoch a permutation of
        the batch from the generator, cut to ``num_mb · mb``."""
        num_mb, mb_size = self.minibatch_shape(batch_size)
        return torch.cat([
            torch.randperm(batch_size, generator=self.generator, device=self.device)
            [: num_mb * mb_size].reshape(num_mb, mb_size)
            for _ in range(self.ppo_epochs)])

    def minibatch_loss(self, instances, actions, old_ll, reward):
        """The clipped surrogate, the Huber value loss and the entropy bonus
        of one minibatch, its actions replayed under autograd. Returns
        ``(loss, metrics)``, the metrics detached."""
        out = self.train_rollout(instances, actions)
        ratio = torch.exp(out.log_likelihood - old_ll)
        value = self.critic(instances)
        adv = reward - value.detach()
        if self.normalize_adv:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = ratio.clamp(1 - self.clip_range, 1 + self.clip_range)
        surrogate = -torch.minimum(ratio * adv, clipped * adv).mean()
        value_loss = huber_loss(value, reward).mean()
        entropy = out.entropy.mean()
        loss = surrogate + self.vf_lambda * value_loss - self.entropy_lambda * entropy
        metrics = {"loss": loss, "surrogate_loss": surrogate, "value_loss": value_loss,
                   "entropy": entropy}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None,
               minibatches: Optional[torch.Tensor] = None) -> dict:
        """One PPO step on ``instances``: the old rollout (sampled, or
        ``replay_actions`` replayed), then one optimiser step per row of
        ``minibatches`` (drawn when not given). Returns the last minibatch's
        metrics and the batch's mean ``reward``, as tensors on the device."""
        instances = instances_to_device(instances, self.device)
        with torch.no_grad():
            out = self.train_rollout(instances, replay_actions)
        batch = out.reward.shape[0]
        if minibatches is None:
            minibatches = self.draw_minibatches(batch)
        for idx in torch.as_tensor(minibatches).to(self.device).long():
            self.optimizer.zero_grad()
            loss, metrics = self.minibatch_loss({k: v[idx] for k, v in instances.items()},
                                                out.actions[idx], out.log_likelihood[idx],
                                                out.reward[idx])
            loss.backward()
            self.optimizer.step()
        self.step += 1
        return {**metrics, "reward": out.reward.mean()}
