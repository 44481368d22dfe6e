"""POMO (Kwon et al. 2020): multistart REINFORCE with the shared baseline
(counterpart of `rl4co_tpu/models/zoo/pomo.py`).

- The policy is AM with 6 encoder layers, instance norm and no graph
  context (`make_pomo_policy`).
- Training samples one rollout from every start node; the advantage is taken
  against the mean reward over an instance's starts, and the loss is meaned
  over (batch, starts).
- Evaluation (`make_eval_step`) runs multistart greedy on the ×8 dihedral
  augmentation and reports max-over-starts and max-over-starts-and-augments.

Flat layouts are repeat-major, as in the JAX package: a rollout's rows are
starts-major ``[S*B]``; in evaluation they are starts-major over
augment-major over batch ``[S*A*B]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.data.transforms import augment_instances
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import instances_to_device, rollout
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy
from rl4co_tpu_torch.rl.baselines import SharedBaseline
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.ops import unbatchify


def make_pomo_policy(env_name: str, **overrides) -> AttentionModelPolicy:
    """AM policy with POMO's deviations; ``overrides`` go to the policy
    (``device`` among them: ``"cuda"`` unless told otherwise)."""
    cfg = dict(
        env_name=env_name,
        num_encoder_layers=6,
        normalization="instance",
        use_graph_context=False,
    )
    cfg.update(overrides)
    return AttentionModelPolicy(**cfg)


class POMO(REINFORCE):
    """POMO algorithm. ``num_starts`` defaults to ``env.get_num_starts()``;
    the train spec becomes multistart sampling over those starts and the
    baseline `SharedBaseline(num_repeats=num_starts)`, whatever is passed.
    Without a ``policy``, `make_pomo_policy(env.name, **policy_kwargs)`."""

    def __init__(
        self,
        env: Env,
        policy: Optional[AttentionModelPolicy] = None,
        num_starts: int = 0,
        num_augment: int = 8,
        augment_fn: str = "dihedral8",
        policy_kwargs: Optional[dict] = None,
        train_spec: DecodeSpec = DecodeSpec(kind="sampling"),
        **kwargs,
    ):
        if policy is None:
            policy = make_pomo_policy(env.name, **(policy_kwargs or {}))
        s = num_starts or env.get_num_starts()
        self.num_starts, self.num_augment, self.augment_fn = s, num_augment, augment_fn
        super().__init__(
            env, policy, baseline=SharedBaseline(num_repeats=s),
            train_spec=dataclasses.replace(train_spec, kind="sampling", multistart=True,
                                           num_starts=s),
            **kwargs)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        out = self.train_rollout(instances, replay_actions)
        reward = unbatchify(out.reward, self.num_starts)           # [B, S]
        ll = unbatchify(out.log_likelihood, self.num_starts)       # [B, S]
        advantage = reward - reward.mean(dim=-1, keepdim=True)
        loss = -(advantage * ll).mean()
        metrics = {
            "loss": loss.detach(),
            "reinforce_loss": loss.detach(),
            "bl_loss": torch.zeros((), device=reward.device),
            "reward": reward.mean(),
            "bl_val": reward.mean(),
            "max_reward": reward.max(dim=-1).values.mean(),
            "entropy": out.entropy.detach().mean(),
        }
        return loss, (metrics, out)

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        a, s = self.num_augment, self.num_starts
        spec = spec or DecodeSpec(kind="greedy", multistart=True, num_starts=s,
                                  tanh_clipping=self.train_spec.tanh_clipping)

        def eval_step(instances) -> dict:
            instances = instances_to_device(instances, self.device)
            if a > 1:
                instances = augment_instances(instances, a, self.augment_fn)
            with torch.no_grad():
                out = rollout(self.policy, self.env, instances, spec,
                              generator=self.generator, device=self.device)
            r = unbatchify(unbatchify(out.reward, s), a)           # [B, A, S]
            max_start = r.max(dim=-1).values                       # [B, A]
            return {
                "reward": r[:, 0, :].mean(),
                "max_reward": max_start[:, 0].mean(),
                "max_aug_reward": max_start.max(dim=-1).values.mean(),
            }

        return eval_step
