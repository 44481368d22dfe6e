"""REINFORCE baselines (counterpart of `rl4co_tpu/rl/baselines.py`).

Each baseline is a frozen config object with the JAX package's four methods:

    init_state(policy, rollout_fn)                   -> BaselineState
    eval(state, instances, reward, rollout_fn)       -> (bl_val [B], bl_loss scalar)
    update_step(state, reward)                       -> BaselineState   (per step, on the device)
    epoch_end(state, policy, rollout_fn, host)       -> (BaselineState, host)   (host side)

``rollout_fn(policy, instances)`` is the algorithm's greedy rollout without a
graph; it returns rewards ``[B]``. Where the JAX package hands parameter
trees around, the port hands policies (`nn.Module`s): the rollout
baseline's snapshot is a frozen deep copy of the live policy. Host-side
state (the rollout baseline's held-out set ``host["eval_instances"]`` and
its incumbent's rewards ``host["eval_rewards"]``) lives in a plain dict
owned by the trainer and enters `epoch_end` only.

In a data-parallel train step (`rl4co_tpu_torch.parallel.mesh.sharded`) the
batch means of the mean and exponential baselines are taken over the global
batch, and the rollout baseline's epoch-end swap is rank 0's decision.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from rl4co_tpu_torch.parallel.mesh import agree_with_rank0, global_mean


@dataclasses.dataclass(frozen=True)
class BaselineState:
    """State shared by all baselines (unused fields stay None)."""

    value: Optional[torch.Tensor] = None   # exponential moving value (scalar; NaN = none yet)
    bl_policy: Optional[nn.Module] = None  # rollout baseline: frozen snapshot of the policy
    epoch: Optional[int] = None            # epochs finished


def _policy_device(policy: nn.Module) -> torch.device:
    return next(policy.parameters()).device


def _nan_scalar(policy: nn.Module) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=torch.float32, device=_policy_device(policy))


def _ema_start(value: torch.Tensor, reward: torch.Tensor) -> torch.Tensor:
    """The moving value, or the batch mean while there is none (NaN) yet."""
    return torch.where(torch.isnan(value), global_mean(reward), value)


def _ema_update(value: torch.Tensor, reward: torch.Tensor, beta: float) -> torch.Tensor:
    m = global_mean(reward)
    return torch.where(torch.isnan(value), m, beta * value + (1 - beta) * m)


def _zero(reward: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=reward.device)


@dataclasses.dataclass(frozen=True)
class Baseline:
    name = "no"

    def init_state(self, policy, rollout_fn) -> BaselineState:
        return BaselineState()

    def eval(self, state: BaselineState, instances, reward, rollout_fn):
        return torch.zeros_like(reward), _zero(reward)

    def update_step(self, state: BaselineState, reward) -> BaselineState:
        return state

    def epoch_end(self, state: BaselineState, policy, rollout_fn, host: dict):
        """Host-side per-epoch hook; returns (state, host)."""
        if state.epoch is not None:
            state = dataclasses.replace(state, epoch=state.epoch + 1)
        return state, host


@dataclasses.dataclass(frozen=True)
class NoBaseline(Baseline):
    name = "no"


@dataclasses.dataclass(frozen=True)
class SharedBaseline(Baseline):
    """Mean over the multistart/multisample group of an instance.

    Assumes the flat batch has the repeat-major layout ``[S*B]`` of the
    rollout's expansion. ``num_repeats`` must be the train spec's number of
    starts or samples: with the default 1 the baseline equals the reward.
    """

    name = "shared"
    num_repeats: int = 1

    def eval(self, state, instances, reward, rollout_fn):
        r = reward.reshape(self.num_repeats, -1)
        bl = r.mean(dim=0, keepdim=True).expand_as(r).reshape(-1)
        return bl, _zero(reward)


@dataclasses.dataclass(frozen=True)
class ExponentialBaseline(Baseline):
    """Exponential moving average of the batch-mean reward."""

    name = "exponential"
    beta: float = 0.8

    def init_state(self, policy, rollout_fn):
        return BaselineState(value=_nan_scalar(policy))

    def eval(self, state, instances, reward, rollout_fn):
        return _ema_start(state.value, reward).expand_as(reward), _zero(reward)

    def update_step(self, state, reward):
        return dataclasses.replace(state, value=_ema_update(state.value, reward, self.beta))


@dataclasses.dataclass(frozen=True)
class MeanBaseline(Baseline):
    """Per-batch mean reward."""

    name = "mean"

    def eval(self, state, instances, reward, rollout_fn):
        return global_mean(reward).expand_as(reward), _zero(reward)


@dataclasses.dataclass(frozen=True)
class CriticBaseline(Baseline):
    """Learned value function: ``critic_fn(instances) -> value [B]`` is bound
    by the algorithm, whose optimiser also holds the critic's parameters."""

    name = "critic"
    critic_fn: Optional[Callable] = dataclasses.field(default=None, compare=False)
    huber: bool = False

    def eval(self, state, instances, reward, rollout_fn):
        if self.critic_fn is None:
            raise ValueError("CriticBaseline requires critic_fn")
        value = self.critic_fn(instances)
        # the value learns toward the reward; the actor sees a detached value
        target = reward.detach()
        if self.huber:
            bl_loss = optax_huber(value, target).mean()
        else:
            bl_loss = (value - target).square().mean()
        return value.detach(), bl_loss


def optax_huber(pred, target, delta: float = 1.0):
    abs_err = (pred - target).abs()
    quad = abs_err.clamp(max=delta)
    return 0.5 * quad ** 2 + delta * (abs_err - quad)


@dataclasses.dataclass(frozen=True)
class RolloutBaseline(Baseline):
    """Greedy rollout of a frozen snapshot of the policy.

    Per step: bl_val = the snapshot's greedy reward on the same instances
    (no graph). Per epoch: challenge on a held-out set; the candidate is
    accepted when its mean reward improves and a one-sided paired t-test is
    significant at ``bl_alpha``.
    """

    name = "rollout"
    bl_alpha: float = 0.05

    def init_state(self, policy, rollout_fn):
        return BaselineState(bl_policy=snapshot_policy(policy), epoch=0)

    def eval(self, state, instances, reward, rollout_fn):
        return rollout_fn(state.bl_policy, instances).detach(), _zero(reward)

    def epoch_end(self, state, policy, rollout_fn, host: dict):
        """T-test challenge on the held-out set. ``host['eval_instances']`` is
        set up by the trainer; ``host['eval_rewards']`` holds the incumbent's
        rewards."""
        state = dataclasses.replace(state, epoch=state.epoch + 1)
        if host.get("eval_instances") is None:
            return state, host
        cand = rollout_fn(policy, host["eval_instances"]).cpu().numpy()
        base = host.get("eval_rewards")
        if base is not None and np.shape(base) != cand.shape:
            # resumed with a held-out set of another size: the restored
            # incumbent's rewards belong to other instances, so the incumbent
            # restarts from the current policy
            base = None
        accept = base is None
        if not accept:
            base = np.asarray(base)
            accept = (cand.mean() - base.mean() > 0
                      and paired_ttest_pvalue(cand, base) < self.bl_alpha)
        if not agree_with_rank0(accept):
            return state, host
        return (dataclasses.replace(state, bl_policy=snapshot_policy(policy)),
                {**host, "eval_rewards": cand})


def snapshot_policy(policy: nn.Module) -> nn.Module:
    """A frozen deep copy: it shares no storage with the live policy, so an
    optimiser step on the one never moves the other."""
    return copy.deepcopy(policy).requires_grad_(False)


def paired_ttest_pvalue(cand: np.ndarray, base: np.ndarray) -> float:
    """One-sided paired t-test p-value (H1: cand > base), by the normal
    approximation to the t distribution, as in the JAX package (accurate to
    about 1e-3 for the n >= 30 used here)."""
    d = cand - base
    n = d.shape[0]
    sd = d.std(ddof=1)
    if sd == 0:
        return 0.0 if d.mean() > 0 else 1.0
    t = d.mean() / (sd / math.sqrt(n))
    return 0.5 * math.erfc(t / math.sqrt(2.0))


@dataclasses.dataclass(frozen=True)
class WarmupBaseline(Baseline):
    """Wraps another baseline; blends it with an exponential baseline over
    the first ``n_epochs``."""

    name = "warmup"
    inner: Baseline = dataclasses.field(default_factory=RolloutBaseline)
    n_epochs: int = 1
    warmup_exp_beta: float = 0.8

    def init_state(self, policy, rollout_fn):
        inner_state = self.inner.init_state(policy, rollout_fn)
        return dataclasses.replace(inner_state, value=_nan_scalar(policy), epoch=0)

    def eval(self, state, instances, reward, rollout_fn):
        # the inner baseline is evaluated at alpha == 0 too, as in the JAX package
        inner_val, inner_loss = self.inner.eval(state, instances, reward, rollout_fn)
        alpha = min(max(state.epoch / self.n_epochs, 0.0), 1.0)
        bl = alpha * inner_val + (1 - alpha) * _ema_start(state.value, reward)
        return bl, alpha * inner_loss

    def update_step(self, state, reward):
        return dataclasses.replace(
            state, value=_ema_update(state.value, reward, self.warmup_exp_beta))

    def epoch_end(self, state, policy, rollout_fn, host):
        return self.inner.epoch_end(state, policy, rollout_fn, host)


REINFORCE_BASELINES = {
    "no": NoBaseline,
    "none": NoBaseline,
    "shared": SharedBaseline,
    "exponential": ExponentialBaseline,
    "mean": MeanBaseline,
    "critic": CriticBaseline,
    "rollout": RolloutBaseline,
    "warmup": WarmupBaseline,
}


def get_reinforce_baseline(name: str, **kwargs) -> Baseline:
    """Factory. ``rollout`` is wrapped in a one-epoch warm-up unless
    ``warmup=False``."""
    if name == "rollout" and kwargs.pop("warmup", True):
        return WarmupBaseline(inner=RolloutBaseline(**kwargs), n_epochs=1)
    cls = REINFORCE_BASELINES.get(name)
    if cls is None:
        raise ValueError(f"Unknown baseline {name}. Available: {sorted(REINFORCE_BASELINES)}")
    return cls(**kwargs)
