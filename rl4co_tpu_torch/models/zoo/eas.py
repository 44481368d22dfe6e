"""Transductive search: Active Search and Efficient Active Search (EAS)
(counterpart of `rl4co_tpu/models/zoo/eas.py`).

- `ActiveSearch` fine-tunes every parameter of a copy of the policy on the
  instances at hand (Bello et al. 2016).
- `EASEmb` fine-tunes the encoder's output embeddings of each instance, on
  the ×8 dihedral augmentation; `EASLay` fine-tunes a residual layer on them
  (Hottung et al. 2022). Their loss is REINFORCE against the mean over the
  starts of a multistart sampling rollout, plus ``eas_lambda`` × the
  imitation of each instance's incumbent tour.

Every search step backpropagates through `precompute` and every decode
step: the multistart rollout runs the grouped pointer kernel (K1) under
autograd, the replay of the incumbents the single-query one (K2). The
optimiser is AdamW with weight decay 1e-6, optax's defaults otherwise.
While EAS runs, the policy's own parameters are frozen, so that the
backward computes the gradient of the trainable tensors alone.

`step` takes one iteration on a `SearchState`; ``replay_actions`` replays
given sampled actions instead of drawing them, which is how the tests hold a
step against the JAX package's.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.data.transforms import augment_instances
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.models.policies.constructive import (
    instances_to_device,
    rollout,
    rollout_from_cache,
)
from rl4co_tpu_torch.utils.optim import get_optimizer
from rl4co_tpu_torch.utils.ops import unbatchify

WEIGHT_DECAY = 1e-6


def _multistart_spec(env, tanh_clipping: float) -> tuple[DecodeSpec, int]:
    s = env.get_num_starts()
    return DecodeSpec(kind="sampling", multistart=True, num_starts=s,
                      tanh_clipping=tanh_clipping), s


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """``module``'s parameters without gradients inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags):
            p.requires_grad_(flag)


@dataclasses.dataclass
class SearchState:
    """What a search carries from one iteration to the next."""

    trainable: dict               # name -> tensor the optimiser updates
    optimizer: object             # `utils.optim.Optimizer` over ``trainable``
    best: torch.Tensor            # [B] best reward so far (-inf before the first)
    best_actions: torch.Tensor    # [B, T] its actions (EAS; zeros before the first)
    have_best: torch.Tensor       # [B] bool
    it: int = 0
    policy: Optional[torch.nn.Module] = None  # Active Search's tuned copy


def _sampling_rollout(policy, env, instances, cache, spec, s, generator, replay_actions):
    """The multistart sampling rollout, or its replay; rewards and
    log-likelihoods ``[B, S]`` and actions ``[B, S, T]``."""
    if replay_actions is not None:
        spec = dataclasses.replace(spec, kind="evaluate")
    out = rollout_from_cache(policy, env, instances, cache, spec, generator, replay_actions)
    return (unbatchify(out.reward, s), unbatchify(out.log_likelihood, s),
            unbatchify(out.actions, s))


def _update_incumbents(state: SearchState, reward, actions):
    """Each instance's best over the starts replaces its incumbent where it
    is better."""
    iter_best, idx = reward.max(dim=-1).values, reward.argmax(dim=-1)
    iter_actions = actions[torch.arange(actions.shape[0], device=actions.device), idx]
    improved = iter_best > state.best
    state.best = torch.where(improved, iter_best, state.best)
    state.best_actions = torch.where(improved[:, None], iter_actions, state.best_actions)
    state.have_best = state.have_best | improved


class _Search:
    """What the three searches share: their configuration, the state of a
    search over ``b`` instances and the loop of ``max_iters`` steps."""

    def __init__(self, env, policy, max_iters: int, lr: float, tanh_clipping: float):
        self.env, self.policy = env, policy
        self.max_iters, self.lr, self.tanh_clipping = max_iters, lr, tanh_clipping
        self.device = next(policy.parameters()).device

    def _new_state(self, trainable: dict, b: int, policy=None) -> SearchState:
        for t in trainable.values():
            t.requires_grad_(True)
        opt = get_optimizer(list(trainable.values()), "adamw", self.lr,
                            weight_decay=WEIGHT_DECAY)
        return SearchState(
            trainable=trainable, optimizer=opt,
            best=torch.full((b,), -torch.inf, device=self.device),
            best_actions=torch.zeros((b, self.env.max_steps), dtype=torch.long,
                                     device=self.device),
            have_best=torch.zeros((b,), dtype=torch.bool, device=self.device), policy=policy)

    def run(self, state: SearchState, generator=None, replay=None) -> SearchState:
        """``max_iters`` steps (``replay[i]``: the actions of iteration i)."""
        for i in range(self.max_iters):
            self.step(state, generator, None if replay is None else replay[i])
        return state


class _EAS(_Search):
    """What EAS-Emb and EAS-Lay share: the loss of an iteration on the
    decoder cache of the (adapted) embeddings."""

    def __init__(self, env, policy, max_iters: int = 200, lr: float = 4.1e-3,
                 eas_lambda: float = 0.013, tanh_clipping: float = 10.0):
        super().__init__(env, policy, max_iters, lr, tanh_clipping)
        self.eas_lambda = eas_lambda

    def _embeddings(self, trainable: dict) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state: SearchState, generator: Optional[torch.Generator] = None,
             replay_actions: Optional[torch.Tensor] = None, keep_grads: bool = False) -> dict:
        """One iteration: the loss, its gradient, the AdamW update and the
        incumbents. Returns the losses, this iteration's rewards and sampled
        actions ``[S*B, T]`` (repeat-major) and, with ``keep_grads``, the
        gradients."""
        spec, s = _multistart_spec(self.env, self.tanh_clipping)
        spec_eval = dataclasses.replace(spec, kind="evaluate", multistart=False, num_starts=0)
        instances = self.instances
        with frozen(self.policy):
            cache = self.policy.precompute(self._embeddings(state.trainable))
            reward, ll, actions = _sampling_rollout(self.policy, self.env, instances, cache,
                                                    spec, s, generator, replay_actions)
            adv = reward - reward.mean(dim=-1, keepdim=True)
            rl_loss = -(adv * ll).mean()
            out_best = rollout_from_cache(self.policy, self.env, instances, cache, spec_eval,
                                          replay_actions=state.best_actions)
            il_loss = -torch.where(state.have_best, out_best.log_likelihood, 0.0).mean()
            loss = rl_loss + self.eas_lambda * il_loss
            state.optimizer.zero_grad()
            loss.backward()
        grads = ({k: v.grad.clone() for k, v in state.trainable.items()} if keep_grads
                 else None)
        state.optimizer.step()
        with torch.no_grad():
            _update_incumbents(state, reward.detach(), actions)
        state.it += 1
        return {"loss": loss.detach(), "rl_loss": rl_loss.detach(), "il_loss": il_loss.detach(),
                "reward": reward.detach(), "grads": grads,
                "actions": actions.transpose(0, 1).reshape(-1, actions.shape[-1])}

class EASEmb(_EAS):
    """EAS-Emb: the encoder's output embeddings of each (augmented) instance
    are the trainable tensor (lr 4.1e-3, λ 0.013, dihedral-8)."""

    def __init__(self, env, policy, max_iters: int = 200, lr: float = 4.1e-3,
                 eas_lambda: float = 0.013, augment_size: int = 8, tanh_clipping: float = 10.0):
        super().__init__(env, policy, max_iters, lr, eas_lambda, tanh_clipping)
        self.augment_size = augment_size

    def init_state(self, instances) -> SearchState:
        instances = instances_to_device(instances, self.device)
        if self.augment_size > 1:
            instances = augment_instances(instances, self.augment_size, "dihedral8")
        self.instances = instances
        with torch.no_grad():
            emb = self.policy.encode(instances).clone()
        return self._new_state({"embeddings": emb}, emb.shape[0])

    def _embeddings(self, trainable):
        return trainable["embeddings"]

    def search(self, instances, generator: Optional[torch.Generator] = None,
               replay=None) -> dict:
        state = self.run(self.init_state(instances), generator, replay)
        best = state.best
        if self.augment_size > 1:
            best = unbatchify(best, self.augment_size).max(dim=-1).values
        return {"embeddings": state.trainable["embeddings"].detach(), "best_reward": best,
                "best_actions": state.best_actions}


# The reference exports EAS with embedding fine-tuning as its default.
EAS = EASEmb


class EASLay(_EAS):
    """EAS-Lay: a residual layer ``emb + relu(emb W1 + b1) W2 + b2`` on the
    encoder's output embeddings is the trainable part; ``W2`` starts at zero,
    so the search starts from the policy itself. No augmentation."""

    def __init__(self, env, policy, max_iters: int = 200, lr: float = 4.1e-3,
                 eas_lambda: float = 0.013, hidden_dim: int = 0, tanh_clipping: float = 10.0):
        super().__init__(env, policy, max_iters, lr, eas_lambda, tanh_clipping)
        self.hidden_dim = hidden_dim

    def init_state(self, instances, generator: Optional[torch.Generator] = None,
                   eas_init: Optional[dict] = None) -> SearchState:
        """``eas_init`` gives the layer's initial tensors (``w1 [D, H]``, ...);
        otherwise ``w1`` is 0.01 × a normal draw from ``generator``."""
        self.instances = instances_to_device(instances, self.device)
        with torch.no_grad():
            self.embeddings = self.policy.encode(self.instances)
        b, _, d = self.embeddings.shape
        h = self.hidden_dim or d
        if eas_init is None:
            eas_init = {"w1": 0.01 * torch.randn(d, h, generator=generator, device=self.device),
                        "b1": torch.zeros(h), "w2": torch.zeros(h, d), "b2": torch.zeros(d)}
        trainable = {k: torch.as_tensor(eas_init[k], dtype=torch.float32).to(self.device).clone()
                     for k in ("w1", "b1", "w2", "b2")}
        return self._new_state(trainable, b)

    def _embeddings(self, p):
        emb = self.embeddings
        return emb + torch.relu(emb @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def search(self, instances, generator: Optional[torch.Generator] = None,
               replay=None, eas_init: Optional[dict] = None) -> dict:
        state = self.run(self.init_state(instances, generator, eas_init), generator, replay)
        return {"eas_params": {k: v.detach() for k, v in state.trainable.items()},
                "best_reward": state.best, "best_actions": state.best_actions}


class ActiveSearch(_Search):
    """Fine-tune every parameter of a copy of the policy on the instances
    (lr 2.6e-4); no imitation term, no augmentation."""

    def __init__(self, env, policy, max_iters: int = 200, lr: float = 2.6e-4,
                 tanh_clipping: float = 10.0):
        super().__init__(env, policy, max_iters, lr, tanh_clipping)

    def init_state(self, instances) -> SearchState:
        self.instances = instances_to_device(instances, self.device)
        tuned = copy.deepcopy(self.policy)
        b = next(iter(self.instances.values())).shape[0]
        return self._new_state(dict(tuned.named_parameters()), b, policy=tuned)

    def step(self, state: SearchState, generator=None, replay_actions=None,
             keep_grads: bool = False) -> dict:
        spec, s = _multistart_spec(self.env, self.tanh_clipping)
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        out = rollout(state.policy, self.env, self.instances, spec, generator,
                      replay_actions, device=self.device)
        reward = unbatchify(out.reward, s)
        ll = unbatchify(out.log_likelihood, s)
        loss = -((reward - reward.mean(dim=-1, keepdim=True)) * ll).mean()
        state.optimizer.zero_grad()
        loss.backward()
        grads = ({k: v.grad.clone() for k, v in state.trainable.items() if v.grad is not None}
                 if keep_grads else None)
        state.optimizer.step()
        state.best = torch.maximum(state.best, reward.detach().max(dim=-1).values)
        state.it += 1
        return {"loss": loss.detach(), "reward": reward.detach(), "grads": grads,
                "actions": out.actions}

    def search(self, instances, generator: Optional[torch.Generator] = None,
               replay=None) -> dict:
        state = self.run(self.init_state(instances), generator, replay)
        return {"policy": state.policy, "best_reward": state.best}
