"""REINFORCE (counterpart of `rl4co_tpu/rl/reinforce.py`).

Where the JAX package threads a `TrainState` through a jitted step, the port
is eager and the algorithm object holds the state: the policy (whose
parameters the optimiser updates in place), the optimiser, the baseline's
state and the step count. One train step is generate → rollout (recording
the graph) → loss → backward → clip → optimiser step → baseline update; the
baseline's greedy rollout and every evaluation run under `torch.no_grad()`.

Randomness is one `torch.Generator` on the policy's device, reseeded by
`reseed(seed, epoch)`: a run resumed at an epoch boundary replays the draws
of the uninterrupted one (the JAX package folds the epoch into its key).

Not ported (ROADMAP.md): ``fused_rollout_baseline`` with its
``temperature_override``; ``chunk``, ``donate`` and ``mesh`` of
``make_train_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import (
    ConstructivePolicy,
    rollout,
)
from rl4co_tpu_torch.rl.baselines import (
    Baseline,
    BaselineState,
    get_reinforce_baseline,
    snapshot_policy,
)
from rl4co_tpu_torch.utils.optim import get_optimizer


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on ``device`` whose seed mixes ``words`` (seed, stream,
    epoch, ...), so that neighbouring tuples give unrelated streams."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]))
    return gen


class REINFORCE:
    """REINFORCE with a pluggable baseline.

    Defaults are the published recipe's: Adam, lr 1e-4, gradients clipped to
    global norm 1.0, greedy rollout baseline behind a one-epoch warm-up. The
    algorithm runs where ``policy`` lives (`AttentionModelPolicy` is built on
    ``"cuda"`` unless told otherwise, and raises without a card).
    """

    def __init__(
        self,
        env: Env,
        policy: ConstructivePolicy,
        baseline: Union[Baseline, str] = "rollout",
        train_spec: DecodeSpec = DecodeSpec(kind="sampling"),
        val_spec: DecodeSpec = DecodeSpec(kind="greedy"),
        lr: float = 1e-4,
        grad_clip: Optional[float] = 1.0,
        optimizer: str = "adam",
        lr_schedule: Optional[Callable[[int], float]] = None,
    ):
        self.env = env
        self.policy = policy
        self.baseline = (get_reinforce_baseline(baseline) if isinstance(baseline, str)
                         else baseline)
        self.train_spec = train_spec
        self.val_spec = val_spec
        self.device = next(policy.parameters()).device
        self.optimizer = get_optimizer(
            policy.parameters(), optimizer,
            lr_schedule if lr_schedule is not None else lr, grad_clip=grad_clip)
        self.baseline_state: BaselineState = self.baseline.init_state(
            policy, self.greedy_reward_fn())
        self.step = 0
        self.generator = seeded_generator(self.device, 0)

    def reseed(self, *words: int) -> None:
        """Restart the random stream from ``words`` (the trainer: seed, epoch)."""
        self.generator = seeded_generator(self.device, *words)

    # ---- components ----

    def greedy_reward_fn(self):
        """``(policy, instances) -> greedy rewards``, without a graph; used by
        the rollout baseline."""
        spec = DecodeSpec(kind="greedy", tanh_clipping=self.train_spec.tanh_clipping,
                          compute_dtype=self.train_spec.compute_dtype)

        def fn(policy, instances):
            with torch.no_grad():
                return rollout(policy, self.env, instances, spec, device=self.device).reward

        return fn

    # ---- loss ----

    def train_rollout(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """The live policy's rollout under ``train_spec``, recording the graph;
        with ``replay_actions`` it replays those (``kind="evaluate"``)."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        return rollout(self.policy, self.env, instances, spec, generator=self.generator,
                       replay_actions=replay_actions, device=self.device)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """REINFORCE loss of the live policy on ``instances``; records the
        graph. Returns ``(loss, (metrics, rollout output))``; the metrics are
        detached tensors. With ``replay_actions`` the rollout replays those
        actions (``kind="evaluate"``) where it would draw its own."""
        out = self.train_rollout(instances, replay_actions)
        bl_val, bl_loss = self.baseline.eval(
            self.baseline_state, instances, out.reward, self.greedy_reward_fn())
        advantage = out.reward - bl_val
        reinforce_loss = -(advantage * out.log_likelihood).mean()
        loss = reinforce_loss + bl_loss
        metrics = {
            "loss": loss.detach(),
            "reinforce_loss": reinforce_loss.detach(),
            "bl_loss": bl_loss.detach(),
            "reward": out.reward.mean(),
            "bl_val": bl_val.mean(),
            "entropy": out.entropy.detach().mean(),
        }
        return loss, (metrics, out)

    # ---- train step ----

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None) -> dict:
        """One optimisation step on ``instances``: loss → backward → clip →
        optimiser step → baseline update. Returns the metrics as tensors on
        the device (nothing is fetched here)."""
        self.optimizer.zero_grad()
        loss, (metrics, out) = self.loss(instances, replay_actions)
        loss.backward()
        self.optimizer.step()
        self.baseline_state = self.baseline.update_step(
            self.baseline_state, out.reward.detach())
        self.step += 1
        return metrics

    def train_step(self, batch_size: int) -> dict:
        """Generate a fresh batch on the device and `update` on it."""
        return self.update(self.env.generate(batch_size, self.generator, self.device))

    # ---- evaluation ----

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        spec = spec or self.val_spec

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = rollout(self.policy, self.env, instances, spec,
                              generator=self.generator, device=self.device)
            return {"reward": out.reward.mean(), "max_reward": out.reward.max()}

        return eval_step

    # ---- epoch-end hook (host side) ----

    def epoch_end(self, host: dict) -> dict:
        self.baseline_state, host = self.baseline.epoch_end(
            self.baseline_state, self.policy, self.greedy_reward_fn(), host)
        return host

    # ---- checkpointing ----

    def state_dict(self) -> dict:
        """Policy, optimiser (with its schedule's step index), baseline state
        (with the snapshot's weights) and step count."""
        bl = self.baseline_state
        return {
            "policy": self.policy.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "baseline": {
                "value": bl.value,
                "epoch": bl.epoch,
                "bl_policy": None if bl.bl_policy is None else bl.bl_policy.state_dict(),
            },
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.optimizer.load_state_dict(state["optimizer"])
        saved = state["baseline"]
        bl_policy = self.baseline_state.bl_policy
        if (bl_policy is None) != (saved["bl_policy"] is None):
            raise ValueError("the checkpoint's baseline does not match this algorithm's")
        if bl_policy is not None:
            bl_policy = snapshot_policy(self.policy)
            bl_policy.load_state_dict(saved["bl_policy"])
        value = saved["value"]
        self.baseline_state = BaselineState(
            value=None if value is None else value.to(self.device),
            bl_policy=bl_policy, epoch=saved["epoch"])
        self.step = int(state["step"])
