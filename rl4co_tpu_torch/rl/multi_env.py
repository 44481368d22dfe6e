"""Mixed-environment REINFORCE: per-env batches in turns, one shared trunk
(counterpart of `rl4co_tpu/rl/multi_env.py`).

One policy (`MultiEnvAttentionPolicy`) holds every env's embeddings and the
shared encoder and pointer; one optimiser updates all of its parameters.
Each env keeps its own baseline state. A dispatch of `make_train_step` runs
``chunk`` consecutive steps of one env, and the dispatches take the envs in
turns from the first: ``chunk`` is therefore not a speed knob but the length
of each env's block, and the trainer picks it as the JAX trainer does
(`Trainer._pick_chunk`). The turn counter lives in the dispatch function, so
it restarts at the first env with every `make_train_step`, as the JAX
package's does with every ``fit``.

The conventions are those of `rl4co_tpu_torch/rl/reinforce.py`: the
algorithm holds the policy, optimiser, baseline states and step count;
randomness is one generator on the policy's device, reseeded per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.models.policies.constructive import rollout
from rl4co_tpu_torch.models.policies.multi_env import MultiEnvAttentionPolicy
from rl4co_tpu_torch.rl.baselines import (
    Baseline,
    BaselineState,
    get_reinforce_baseline,
    snapshot_policy,
)
from rl4co_tpu_torch.rl.reinforce import seeded_generator
from rl4co_tpu_torch.utils.optim import get_optimizer


class MultiEnvREINFORCE:
    """REINFORCE over several envs with a shared-trunk policy.

    ``envs``: ``{name: Env}``; the first is the primary env, on which the
    trainer generates and runs its validation (``env``, `make_eval_step`'s
    default), as the JAX trainer does. The default policy is
    `MultiEnvAttentionPolicy` at AM's published widths on ``device``. Adam
    at ``lr``, gradients clipped to global norm ``grad_clip``.
    """

    def __init__(
        self,
        envs: dict,
        policy: Optional[MultiEnvAttentionPolicy] = None,
        baseline: Union[Baseline, str] = "exponential",
        train_spec: DecodeSpec = DecodeSpec(kind="sampling", tanh_clipping=10.0),
        val_spec: DecodeSpec = DecodeSpec(kind="greedy", tanh_clipping=10.0),
        lr: float = 1e-4,
        grad_clip: Optional[float] = 1.0,
        device="cuda",
    ):
        self.envs = dict(envs)
        names = tuple(self.envs)
        if policy is None:
            policy = MultiEnvAttentionPolicy(env_name=names[0], env_names=names, device=device)
        if set(policy.env_names) != set(names):
            raise ValueError(f"policy embeds {policy.env_names}, the envs are {names}")
        self.policy = policy
        self.baselines = {n: get_reinforce_baseline(baseline) if isinstance(baseline, str)
                          else baseline for n in names}
        self.train_spec = train_spec
        self.val_spec = val_spec
        self.device = next(policy.parameters()).device
        self.optimizer = get_optimizer(policy.parameters(), "adam", lr, grad_clip=grad_clip)
        self.baseline_states = {n: self.baselines[n].init_state(policy, self.greedy_reward_fn(n))
                                for n in names}
        self.step = 0
        self.generator = seeded_generator(self.device, 0)

    @property
    def env(self):
        """The primary (first) env."""
        return next(iter(self.envs.values()))

    def reseed(self, *words: int) -> None:
        """Restart the random stream from ``words`` (the trainer: seed, epoch)."""
        self.generator = seeded_generator(self.device, *words)

    def greedy_reward_fn(self, name: str):
        """``(policy, instances) -> greedy rewards`` on env ``name`` (through
        ``policy.for_env(name)``), without a graph, in the train spec's
        compute dtype."""
        spec = DecodeSpec(kind="greedy", tanh_clipping=self.train_spec.tanh_clipping,
                          compute_dtype=self.train_spec.compute_dtype)
        env = self.envs[name]

        def fn(policy, instances):
            with torch.no_grad():
                return rollout(policy.for_env(name), env, instances, spec,
                               device=self.device).reward

        return fn

    def loss(self, name: str, instances, replay_actions: Optional[torch.Tensor] = None):
        """REINFORCE loss on env ``name``; records the graph. Returns
        ``(loss, (metrics, rollout output))``; with ``replay_actions`` the
        rollout replays those (``kind="evaluate"``)."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        out = rollout(self.policy.for_env(name), self.envs[name], instances, spec,
                      generator=self.generator, replay_actions=replay_actions,
                      device=self.device)
        bl_val, bl_loss = self.baselines[name].eval(
            self.baseline_states[name], instances, out.reward, self.greedy_reward_fn(name))
        loss = -((out.reward - bl_val) * out.log_likelihood).mean() + bl_loss
        return loss, ({"loss": loss.detach(), "reward": out.reward.mean()}, out)

    def update(self, name: str, instances,
               replay_actions: Optional[torch.Tensor] = None) -> dict:
        """One optimisation step on env ``name``'s ``instances``: loss →
        backward → clip → optimiser step → that env's baseline update.
        Returns the metrics as tensors on the device."""
        self.optimizer.zero_grad()
        loss, (metrics, out) = self.loss(name, instances, replay_actions)
        loss.backward()
        # the other envs' embeddings take no part: optax gives them a zero
        # gradient, so that Adam still moves them by their moments and counts
        # the step; `torch.optim.Adam` would skip a parameter without one
        for p in self.policy.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.baseline_states[name] = self.baselines[name].update_step(
            self.baseline_states[name], out.reward.detach())
        self.step += 1
        return metrics

    def make_train_step(self, batch_size: int, chunk: int = 1):
        """A dispatch function: each call runs ``chunk`` steps of the next env
        in turn, each on a fresh batch, and returns the last step's metrics
        with ``"env"``, the env's name."""
        names = list(self.envs)
        dispatches = [0]

        def dispatch() -> dict:
            name = names[dispatches[0] % len(names)]
            dispatches[0] += 1
            env = self.envs[name]
            for _ in range(chunk):
                metrics = self.update(name, env.generate(batch_size, self.generator, self.device))
            return {**metrics, "env": name}

        return dispatch

    def make_eval_step(self, spec: Optional[DecodeSpec] = None, env_name: Optional[str] = None):
        """Evaluation on env ``env_name`` (the primary env by default)."""
        spec = spec or self.val_spec
        name = env_name or next(iter(self.envs))
        policy, env = self.policy.for_env(name), self.envs[name]

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = rollout(policy, env, instances, spec, generator=self.generator,
                              device=self.device)
            return {"reward": out.reward.mean(), "max_reward": out.reward.max()}

        return eval_step

    def epoch_end(self, host: dict) -> dict:
        """Nothing: as in the JAX package, no baseline is updated per epoch."""
        return host

    def state_dict(self) -> dict:
        """Policy, optimiser, every env's baseline state and the step count."""
        return {
            "policy": self.policy.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "baselines": {n: {"value": bl.value, "epoch": bl.epoch,
                              "bl_policy": None if bl.bl_policy is None
                              else bl.bl_policy.state_dict()}
                          for n, bl in self.baseline_states.items()},
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.optimizer.load_state_dict(state["optimizer"])
        if set(state["baselines"]) != set(self.baseline_states):
            raise ValueError("the checkpoint's envs do not match this algorithm's")
        for name, saved in state["baselines"].items():
            bl_policy = self.baseline_states[name].bl_policy
            if (bl_policy is None) != (saved["bl_policy"] is None):
                raise ValueError("the checkpoint's baseline does not match this algorithm's")
            if bl_policy is not None:
                bl_policy = snapshot_policy(self.policy)
                bl_policy.load_state_dict(saved["bl_policy"])
            value = saved["value"]
            self.baseline_states[name] = BaselineState(
                value=None if value is None else value.to(self.device),
                bl_policy=bl_policy, epoch=saved["epoch"])
        self.step = int(state["step"])
