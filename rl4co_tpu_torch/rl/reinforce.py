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

With a mesh (`rl4co_tpu_torch.parallel.mesh`), `train_step` generates the
global batch on every rank, keeps this rank's rows and runs `update` on them
inside `sharded`: batch norm, the baselines' means, the draws and the
metrics are global, and the gradients are averaged across ranks before the
optimiser step, so every rank takes the one-device run's step.

``fused_rollout_baseline`` (rollout baseline without its warm-up, as in the
JAX package) computes the baseline in a second rollout: the snapshot's at
temperature 1e-9 from the same generator state as the live rollout; the JAX
package runs both as members of one vmapped scan. Not ported (ROADMAP.md):
``chunk`` and ``donate`` of ``make_train_step``.
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
    RolloutOutput,
    rollout,
)
from rl4co_tpu_torch.parallel.mesh import (
    Mesh,
    active_shard,
    global_means,
    shard_batch,
    sharded,
)
from rl4co_tpu_torch.rl.baselines import (
    Baseline,
    BaselineState,
    RolloutBaseline,
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


class ConstructiveAlgorithm:
    """What every algorithm over a constructive policy shares: the env, the
    policy and its device, the train and validation decode specs, the step
    count and the random stream (one `torch.Generator` on the policy's
    device, reseeded by `reseed`), the sampling rollout and the greedy
    evaluation."""

    # whether a data-parallel step (`train_step(batch, mesh)`) is the
    # one-device step, which the Trainer asks before it takes a mesh: a loss
    # that takes batch means of its own (rather than through the baseline)
    # is not; an algorithm without the attribute does not train data-parallel
    data_parallel = False

    def __init__(self, env: Env, policy: ConstructivePolicy, train_spec: DecodeSpec,
                 val_spec: DecodeSpec):
        self.env = env
        self.policy = policy
        self.train_spec = train_spec
        self.val_spec = val_spec
        self.device = next(policy.parameters()).device
        self.step = 0
        self.generator = seeded_generator(self.device, 0)

    def reseed(self, *words: int) -> None:
        """Restart the random stream from ``words`` (the trainer: seed, epoch)."""
        self.generator = seeded_generator(self.device, *words)

    def greedy_reward_fn(self):
        """``(policy, instances) -> greedy rewards``, without a graph; used by
        the rollout baseline."""
        spec = DecodeSpec(kind="greedy", tanh_clipping=self.train_spec.tanh_clipping,
                          compute_dtype=self.train_spec.compute_dtype)

        def fn(policy, instances):
            with torch.no_grad():
                return rollout(policy, self.env, instances, spec, device=self.device).reward

        return fn

    def train_rollout(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """The live policy's rollout under ``train_spec``, recording the graph;
        with ``replay_actions`` it replays those (``kind="evaluate"``)."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        return rollout(self.policy, self.env, instances, spec, generator=self.generator,
                       replay_actions=replay_actions, device=self.device)

    def train_step(self, batch_size: int) -> dict:
        """Generate a fresh batch on the device and `update` on it."""
        return self.update(self.env.generate(batch_size, self.generator, self.device))

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        spec = spec or self.val_spec

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = rollout(self.policy, self.env, instances, spec,
                              generator=self.generator, device=self.device)
            return {"reward": out.reward.mean(), "max_reward": out.reward.max()}

        return eval_step


class REINFORCE(ConstructiveAlgorithm):
    """REINFORCE with a pluggable baseline.

    Defaults are the published recipe's: Adam, lr 1e-4, gradients clipped to
    global norm 1.0, greedy rollout baseline behind a one-epoch warm-up. The
    algorithm runs where ``policy`` lives (`AttentionModelPolicy` is built on
    ``"cuda"`` unless told otherwise, and raises without a card).
    """

    data_parallel = True

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
        fused_rollout_baseline: bool = False,
    ):
        super().__init__(env, policy, train_spec, val_spec)
        self.fused_rollout_baseline = fused_rollout_baseline
        self.baseline = (get_reinforce_baseline(baseline) if isinstance(baseline, str)
                         else baseline)
        self.optimizer = get_optimizer(
            policy.parameters(), optimizer,
            lr_schedule if lr_schedule is not None else lr, grad_clip=grad_clip)
        self.baseline_state: BaselineState = self.baseline.init_state(
            policy, self.greedy_reward_fn())

    # ---- loss ----

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """REINFORCE loss of the live policy on ``instances``; records the
        graph. Returns ``(loss, (metrics, rollout output))``; the metrics are
        detached tensors. With ``replay_actions`` the rollout replays those
        actions (``kind="evaluate"``) where it would draw its own."""
        if self.fused_rollout_baseline and isinstance(self.baseline, RolloutBaseline):
            return self._fused_loss(instances, replay_actions)
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

    def baseline_rollout(self, instances) -> RolloutOutput:
        """The fused baseline's member: the snapshot's rollout under the
        train spec at temperature 1e-9 (greedy but at exact ties), drawing
        from a copy of the generator as the live rollout is about to."""
        generator = torch.Generator(device=self.device)
        generator.set_state(self.generator.get_state())
        with torch.no_grad():
            return rollout(self.baseline_state.bl_policy, self.env, instances,
                           dataclasses.replace(self.train_spec, temperature=1e-9),
                           generator=generator, device=self.device)

    def _fused_loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """The JAX package's `_fused_loss`: the baseline is member 1's reward,
        without a baseline loss."""
        bl_val = self.baseline_rollout(instances).reward
        out = self.train_rollout(instances, replay_actions)
        advantage = out.reward - bl_val
        reinforce_loss = -(advantage * out.log_likelihood).mean()
        metrics = {
            "loss": reinforce_loss.detach(),
            "reinforce_loss": reinforce_loss.detach(),
            "bl_loss": torch.zeros((), device=self.device),
            "reward": out.reward.mean(),
            "bl_val": bl_val.mean(),
            "entropy": out.entropy.detach().mean(),
        }
        return reinforce_loss, (metrics, out)

    # ---- train step ----

    def train_step(self, batch_size: int, mesh: Optional[Mesh] = None) -> dict:
        """Generate a fresh batch of ``batch_size`` on the device and `update`
        on it; with ``mesh``, on this rank's rows of it (the batch is the
        global one)."""
        instances = self.env.generate(batch_size, self.generator, self.device)
        if mesh is None:
            return self.update(instances)
        with sharded(mesh, mesh.local_batch(batch_size)):
            return self.update(shard_batch(instances, mesh))

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None) -> dict:
        """One optimisation step on ``instances``: loss → backward → clip →
        optimiser step → baseline update. Returns the metrics as tensors on
        the device (nothing is fetched here). In a data-parallel step the
        gradients are averaged across ranks before the clip, and the metrics
        are global means."""
        self.optimizer.zero_grad()
        loss, (metrics, out) = self.loss(instances, replay_actions)
        loss.backward()
        shard = active_shard()
        if shard is not None:
            shard.mesh.average_gradients(self.policy.parameters())
            metrics = global_means(metrics)
        self.optimizer.step()
        self.baseline_state = self.baseline.update_step(
            self.baseline_state, out.reward.detach())
        self.step += 1
        return metrics

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
