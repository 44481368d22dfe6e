"""Stepwise PPO (counterpart of `rl4co_tpu/rl/stepwise_ppo.py`), for L2D's
policy with its critic on FJSP and JSSP.

One step: generate a batch, roll the current policy out by sampling and
keep every step's state, action, log-probability and reward (the decrease
of the makespan's lower bound, `env.calc_lower_bound`), flatten the
``[T, B]`` transitions, then ``ppo_epochs`` epochs of clipped PPO over
random minibatches of ``mini_batch_size`` (the steps after an episode ended
weigh nothing), each minibatch one Adam step behind clipping by global norm
``max_grad_norm``. The metrics are the last minibatch's, and the reward is
minus the rollout's mean makespan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.decoding import (
    DecodeSpec,
    decode_action,
    process_logits_spec,
    take_along_last,
)
from rl4co_tpu_torch.models.policies.constructive import instances_to_device
from rl4co_tpu_torch.models.zoo.l2d import SchedulingAlgorithm, l2d_rollout


def stack_states(states: list):
    """``T`` states ``[B, ...]`` -> one state ``[T*B, ...]``, step-major."""
    cls = type(states[0])
    return cls(**{f.name: torch.cat([getattr(s, f.name) for s in states], dim=0)
                  for f in dataclasses.fields(cls)})


def index_state(state, idx: torch.Tensor):
    """The rows ``idx`` of every field of ``state``."""
    return type(state)(**{f.name: getattr(state, f.name)[idx]
                          for f in dataclasses.fields(state)})


def makespan(state) -> torch.Tensor:
    """The latest finish of a real operation of each row of an FJSP/JSSP state."""
    return torch.where(state.pad_mask, -torch.inf, state.finish_times).amax(dim=-1)


class StepwisePPO(SchedulingAlgorithm):
    """Clipped PPO over single decode steps; ``policy(state) -> (logits,
    value)`` (`L2DPolicy(with_critic=True)`)."""

    def __init__(self, env, policy, clip_range: float = 0.2, ppo_epochs: int = 2,
                 mini_batch_size: int = 256, vf_lambda: float = 0.5,
                 entropy_lambda: float = 0.01, max_grad_norm: float = 0.5, lr: float = 1e-4,
                 train_spec: DecodeSpec = DecodeSpec(kind="sampling")):
        super().__init__(env, policy, lr, max_grad_norm, train_spec)
        self.clip_range, self.ppo_epochs = clip_range, ppo_epochs
        self.mini_batch_size = mini_batch_size
        self.vf_lambda, self.entropy_lambda = vf_lambda, entropy_lambda

    def rollout(self, instances, spec: DecodeSpec, replay_actions=None):
        return l2d_rollout(self.policy, self.env, instances, spec, self.generator,
                           replay_actions)

    def _lb_max(self, state) -> torch.Tensor:
        return self.env.calc_lower_bound(state).amax(dim=-1)

    def collect(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """The old policy's rollout without a graph: (final state, the
        ``[T*B]`` states, actions, log-probabilities, rewards, valid flags).
        ``replay_actions [B, T]`` replace the draws."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        state = self.env.reset(instances)
        states, actions, logps, rewards, valid = [], [], [], [], []
        with torch.no_grad():
            for t in range(self.env.max_steps):
                mask = self.env.action_mask(state)
                logits, _ = self.policy(state)
                lp_all = process_logits_spec(logits.float(), mask, spec)
                replay_t = replay_actions[:, t] if replay_actions is not None else None
                action, logp = decode_action(lp_all, mask, spec, self.generator, replay_t)
                lb_before = self._lb_max(state)
                next_state = self.env.step(state, action)
                states.append(state)
                actions.append(action)
                logps.append(logp)
                rewards.append(-(self._lb_max(next_state) - lb_before))
                valid.append(~state.done)
                state = next_state
        return (state, stack_states(states), torch.cat(actions), torch.cat(logps),
                torch.cat(rewards), torch.cat(valid))

    def minibatch_loss(self, states, actions, old_lp, rewards, valid):
        logits, value = self.policy(states)
        mask = self.env.action_mask(states)
        logprobs = process_logits_spec(logits.float(), mask, self.train_spec)
        lp = take_along_last(logprobs, actions)
        probs = logprobs.exp()
        entropy = -torch.where(probs > 0, probs * logprobs, 0.0).sum(-1)
        w = valid.float()
        wsum = w.sum() + 1e-9
        ratios = torch.exp(lp - old_lp)
        adv = rewards - value.detach()
        surr = -torch.minimum(ratios * adv,
                              ratios.clamp(1 - self.clip_range, 1 + self.clip_range) * adv)
        surrogate = (surr * w).sum() / wsum
        value_loss = ((value - rewards).square() * w).sum() / wsum
        ent = (entropy * w).sum() / wsum
        loss = surrogate + self.vf_lambda * value_loss - self.entropy_lambda * ent
        return loss, {"loss": loss.detach(), "surrogate_loss": surrogate.detach(),
                      "value_loss": value_loss.detach(), "entropy": ent.detach()}

    def minibatches(self, total: int) -> torch.Tensor:
        """``[epochs * num_mb, mb]`` row indices: per epoch a permutation of the
        ``total`` transitions cut into ``total // mb`` minibatches."""
        mb = min(self.mini_batch_size, total)
        num_mb = total // mb
        return torch.cat([
            torch.randperm(total, generator=self.generator, device=self.device)[: num_mb * mb]
            .reshape(num_mb, mb) for _ in range(self.ppo_epochs)])

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None,
               minibatches: Optional[torch.Tensor] = None, on_minibatch=None) -> dict:
        """One PPO step on ``instances``. ``replay_actions [B, T]`` and
        ``minibatches [epochs * num_mb, mb]`` replace the draws;
        ``on_minibatch(i, loss, metrics)`` is called after each backward,
        before the optimiser step (the tests read the gradients there)."""
        instances = instances_to_device(instances, self.device)
        if replay_actions is not None:
            replay_actions = torch.as_tensor(replay_actions).to(self.device)
        final_state, states, actions, old_lp, rewards, valid = self.collect(
            instances, replay_actions)
        if minibatches is None:
            minibatches = self.minibatches(actions.shape[0])
        minibatches = torch.as_tensor(minibatches).to(self.device).long()
        metrics = {}
        for i, idx in enumerate(minibatches):
            self.optimizer.zero_grad()
            loss, metrics = self.minibatch_loss(index_state(states, idx), actions[idx],
                                                old_lp[idx], rewards[idx], valid[idx])
            loss.backward()
            if on_minibatch is not None:
                on_minibatch(i, loss, metrics)
            self.optimizer.step()
        self.step += 1
        return {**metrics, "reward": (-makespan(final_state)).mean()}
