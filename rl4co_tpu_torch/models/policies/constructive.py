"""Constructive (autoregressive) policy engine (counterpart of
`rl4co_tpu/models/policies/constructive.py`):

    encode once → precompute decoder cache → loop over decode steps
    (logits → process → select → env.step) → reward + log-likelihood.

The loop is a Python loop with a static trip count (``env.max_steps``) and
done-masking. Multistart (POMO) and multi-sample expansion keep the decoder
cache **untiled** ``[B, ...]``: the repeats of an instance become a query
axis that shares one K/V load, and the encoder never runs per start. An env
with a dynamic embedding (SDVRP) is the exception: its K/V change with each
repeat's state, so its cache is tiled per repeat.

Whether a rollout records an autograd graph follows the ambient grad mode,
as everywhere in PyTorch: the loss of a training step calls `rollout` with
gradients enabled (encoder, `precompute` and every decode step are then
recorded); everything that only needs tours or rewards (`evaluate_policy`,
a baseline's greedy rollout, validation) calls it under `torch.no_grad()`.

With ``spec.compute_dtype`` the whole rollout runs, through
`torch.func.functional_call`, on the parameters rounded through that dtype
(`rl4co_tpu_torch/utils/dtype.py`); the f32 masters receive the gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from rl4co_tpu_torch.decoding import (
    DecodeSpec,
    decode_action,
    get_log_likelihood,
    process_logits_spec,
)
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import DYNAMIC_EMBEDDING_REGISTRY
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.dtype import computing_in, rounded_parameters, torch_dtype
from rl4co_tpu_torch.utils.ops import batchify, unbatchify


@dataclasses.dataclass
class PrecomputedCache:
    """Decoder cache."""

    node_embeddings: torch.Tensor  # [B, N, D]
    graph_context: Any             # [B, D] or 0.0
    glimpse_key: torch.Tensor      # [B, N, D]
    glimpse_val: torch.Tensor      # [B, N, D]
    logit_key: torch.Tensor        # [B, N, D]


@dataclasses.dataclass
class RolloutOutput:
    reward: torch.Tensor          # [B'] (B' = B * num_repeats when expanded)
    log_likelihood: torch.Tensor  # [B']
    actions: torch.Tensor         # [B', T]
    logprobs: torch.Tensor        # [B', T] chosen-action logprobs (0 after done)
    entropy: torch.Tensor         # [B'] summed per-step policy entropy


class ConstructivePolicy(nn.Module):
    """Protocol for constructive policies: subclasses implement
    ``encode`` / ``precompute`` / ``decode_step``."""

    def encode(self, instances) -> torch.Tensor:
        raise NotImplementedError

    def precompute(self, embeddings) -> PrecomputedCache:
        raise NotImplementedError

    def decode_step(self, cache: PrecomputedCache, state, mask,
                    num_repeats: int = 1) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, fn, *args):
        """``fn(*args)``: what `torch.func.functional_call` runs on this
        policy, so that a whole rollout sees the parameters it substitutes."""
        return fn(*args)


def policy_tp_roles(policy: nn.Module, env: Optional[Env] = None, key=None) -> dict:
    """The tensor-parallel role markers of ``policy`` (each `TPDense`'s
    ``tp_role``) as the JAX package's marker tree:
    ``{"encoder_net": {"layer_0": {"mha": {"out_proj": {"tp_role": "row"}, ...}}}}``,
    for `rl4co_tpu_torch.parallel.mesh.shard_params_model_axis(roles=...)`.
    ``env`` and ``key`` serve the JAX package's initialisation run and are
    not needed: a port module holds its layers from construction."""
    from rl4co_tpu_torch.models.nn.ops import TPDense

    roles: dict = {}
    for name, mod in policy.named_modules():
        if isinstance(mod, TPDense):
            node = roles
            for part in name.split("."):
                node = node.setdefault(part, {})
            node["tp_role"] = mod.tp_role
    return roles


def instances_to_device(instances: dict, device: torch.device) -> dict:
    """numpy arrays or tensors -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in instances.items()}


def rollout(
    policy: ConstructivePolicy,
    env: Env,
    instances,
    spec: DecodeSpec,
    generator: Optional[torch.Generator] = None,
    replay_actions: Optional[torch.Tensor] = None,
    device="cuda",
) -> RolloutOutput:
    """Full autoregressive rollout. Under `torch.no_grad()` it records no
    graph; with gradients enabled ``log_likelihood``, ``logprobs`` and
    ``entropy`` carry the graph back to the policy's parameters.

    Args:
        instances: batched instance dict ``[B, ...]`` (numpy or tensors).
        spec: static decode configuration. With ``spec.multistart`` the
            output batch is ``B * num_starts`` in repeat-major layout
            (``unbatchify(x, num_starts) -> [B, num_starts]``).
        generator: source of the draws for ``kind='sampling'``, on ``device``.
        replay_actions: ``[B', T]`` actions for ``kind='evaluate'``.
        device: where the rollout runs; the policy must already be there.
    """
    device = resolve_device(device)
    param = next(policy.parameters())
    if param.device.type != device.type:
        raise ValueError(f"policy is on {param.device}, rollout asked for {device}")
    instances = instances_to_device(instances, device)
    if replay_actions is not None:
        replay_actions = torch.as_tensor(replay_actions).to(device)
    args = (policy, env, instances, spec, generator, replay_actions)
    if spec.compute_dtype is None:
        return _rollout(*args)
    dtype = torch_dtype(spec.compute_dtype)
    params = rounded_parameters(policy, dtype)
    with computing_in(dtype):
        return torch.func.functional_call(policy, params, (_rollout, *args, params))


def _rollout(policy, env, instances, spec, generator, replay_actions,
             params=None) -> RolloutOutput:
    if spec.kind == "beam_search":
        from rl4co_tpu_torch.models.policies.beam_search import beam_search_rollout

        width = spec.beam_width or env.get_num_starts()
        return beam_search_rollout(policy, env, instances, width, spec,
                                   select_best=spec.select_best)
    cache = policy.precompute(policy.encode(instances))
    return rollout_from_cache(policy, env, instances, cache, spec,
                              generator, replay_actions, params=params)


def rollout_from_cache(
    policy: ConstructivePolicy,
    env: Env,
    instances,
    cache: PrecomputedCache,
    spec: DecodeSpec,
    generator: Optional[torch.Generator] = None,
    replay_actions: Optional[torch.Tensor] = None,
    params: Optional[dict] = None,
) -> RolloutOutput:
    """Decode loop from a precomputed cache, on the cache's device.

    With repeats (starts or samples) the cache stays untiled and the repeats
    are the decoder's query axis, unless the env has a dynamic embedding:
    then each repeat's K/V differ, and the cache is tiled per repeat
    (repeat-major, as the state) and decoded one query per row."""
    first_actions = None
    num_repeats = 1
    if spec.multistart and spec.num_starts > 1:
        s = spec.num_starts
        starts = env.select_start_nodes(instances, s)        # [B, S]
        first_actions = starts.t().reshape(-1)               # repeat-major [S*B]
        instances = batchify(instances, s)
        num_repeats = s
    elif spec.num_samples > 1:
        instances = batchify(instances, spec.num_samples)
        num_repeats = spec.num_samples
    decode_repeats = num_repeats
    if num_repeats > 1 and env.name in DYNAMIC_EMBEDDING_REGISTRY:
        cache = batchify(cache, num_repeats)
        decode_repeats = 1

    state = env.reset(instances)
    actions, logprobs_chosen = [], []
    entropy = torch.zeros_like(state.done, dtype=torch.float32)
    for t in range(env.max_steps):
        mask = env.action_mask(state)
        logits = decode_logits(policy, cache, state, mask, decode_repeats, spec, params)
        logprobs = process_logits_spec(logits.float(), mask, spec)
        replay_t = replay_actions[:, t] if replay_actions is not None else None
        action, logprob = decode_action(logprobs, mask, spec, generator, replay_t)
        if first_actions is not None and t == 0:
            action = first_actions
            logprob = torch.zeros_like(logprob)
        # steps after done contribute nothing
        probs = logprobs.exp()
        step_entropy = -torch.where(probs > 0, probs * logprobs, 0.0).sum(dim=-1)
        logprobs_chosen.append(torch.where(state.done, 0.0, logprob))
        entropy = entropy + torch.where(state.done, 0.0, step_entropy)
        actions.append(action)
        state = env.step(state, action)

    actions = torch.stack(actions, dim=1)            # [B', T]
    logprobs_chosen = torch.stack(logprobs_chosen, dim=1)
    out = RolloutOutput(
        reward=env.reward(state, actions),
        log_likelihood=get_log_likelihood(logprobs_chosen),
        actions=actions,
        logprobs=logprobs_chosen,
        entropy=entropy,
    )
    if num_repeats > 1 and spec.select_best:
        out = select_best(out, num_repeats)
    return out


def decode_logits(policy, cache, state, mask, num_repeats: int, spec: DecodeSpec,
                  params: Optional[dict] = None) -> torch.Tensor:
    """The decode step's logits. Under ``spec.remat`` with a graph, the
    step's intermediates are dropped and recomputed in the backward pass
    (`torch.utils.checkpoint`), on the parameters the rollout runs on:
    ``params``, the rounded ones of a compute dtype, or the policy's own."""
    if not (spec.remat and torch.is_grad_enabled()):
        return policy.decode_step(cache, state, mask, num_repeats)

    def step(cache, state, mask):
        if params is None:
            return policy.decode_step(cache, state, mask, num_repeats)
        with computing_in(torch_dtype(spec.compute_dtype)):
            return torch.func.functional_call(
                policy, params, (policy.decode_step, cache, state, mask, num_repeats))

    return torch.utils.checkpoint.checkpoint(step, cache, state, mask, use_reentrant=False,
                                             preserve_rng_state=False)


def select_best(out: RolloutOutput, num_repeats: int) -> RolloutOutput:
    """Reduce the starts/samples axis by max reward."""
    grouped = unbatchify(out, num_repeats)  # fields become [B, R, ...]
    best = torch.argmax(grouped.reward, dim=-1)  # [B]

    def take(x):
        idx = best.reshape(best.shape + (1,) * (x.ndim - 1))
        return torch.gather(x, 1, idx.expand(-1, 1, *x.shape[2:]))[:, 0]

    return RolloutOutput(**{
        f.name: take(getattr(grouped, f.name)) for f in dataclasses.fields(grouped)
    })
