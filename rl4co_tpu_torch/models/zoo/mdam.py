"""MDAM, the Multi-Decoder Attention Model (Xin et al. 2021; counterpart of
`rl4co_tpu/models/zoo/mdam.py`).

``num_paths`` (default 5) decoders, each with its own context embedding,
projections and pointer, share one AM encoder. Each path decodes through the
pointer kernel: a greedy TSP-50 dispatch is ``5 × 50`` launches of the
single-query kernel. Training: REINFORCE per path against the path's batch
mean, minus ``kl_coef`` times the pairwise KL of the paths' first-step
policies (diversity). Evaluation reports the paths' mean and the best path.

Embedding-Glimpse: every ``eg_step_gap`` decode steps the encoder's last
layer is rerun on its cached input with the current action mask as key
mask, and the path's cache rebuilt (`rollout_eg`). With the default gap of
200 it never runs below N 200. The JAX package uses the action mask for
every env (the reference's non-VRP branch cannot run), and so does the port.

As in the JAX package, MDAM ignores the algorithm's baseline argument (its
per-path means are built in) and computes in f32 whatever the train spec's
compute dtype: the loss decodes from the cache without the cast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec, decode_action, process_logits_spec
from rl4co_tpu_torch.models.nn.attention import PointerAttention
from rl4co_tpu_torch.models.nn.env_embeddings import env_context_embedding, env_init_embedding
from rl4co_tpu_torch.models.nn.graph.attnnet import GraphAttentionNetwork
from rl4co_tpu_torch.models.policies.constructive import (
    ConstructivePolicy,
    PrecomputedCache,
    RolloutOutput,
    instances_to_device,
    rollout_from_cache,
)
from rl4co_tpu_torch.rl.baselines import NoBaseline
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.device import resolve_device


class MDAMPolicy(ConstructivePolicy):
    """Shared AM encoder, ``num_paths`` decoders (sub-modules
    ``context_embeddings_{p}``, ``project_node_embeddings_{p}``,
    ``project_fixed_contexts_{p}``, ``pointers_{p}``: the Flax tree's names)."""

    def __init__(self, env_name: str = "tsp", embed_dim: int = 128,
                 num_encoder_layers: int = 3, num_heads: int = 8,
                 feedforward_hidden: int = 512, normalization: str = "batch",
                 num_paths: int = 5, mask_inner: bool = True, eg_step_gap: int = 200,
                 pointer_impl: str = "kernel", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.env_name, self.embed_dim = env_name, embed_dim
        self.num_paths, self.eg_step_gap = num_paths, eg_step_gap
        self.init_embedding = env_init_embedding(env_name, embed_dim)
        self.encoder_net = GraphAttentionNetwork(
            embed_dim=embed_dim, num_heads=num_heads, num_layers=num_encoder_layers,
            normalization=normalization, feedforward_hidden=feedforward_hidden)
        for p in range(num_paths):
            self.add_module(f"context_embeddings_{p}", env_context_embedding(env_name, embed_dim))
        for p in range(num_paths):
            self.add_module(f"project_node_embeddings_{p}",
                            nn.Linear(embed_dim, 3 * embed_dim, bias=False))
        for p in range(num_paths):
            self.add_module(f"project_fixed_contexts_{p}",
                            nn.Linear(embed_dim, embed_dim, bias=False))
        for p in range(num_paths):
            self.add_module(f"pointers_{p}", PointerAttention(
                embed_dim, num_heads, impl=pointer_impl, mask_inner=mask_inner))
        self.to(device)

    def encode(self, instances) -> torch.Tensor:
        return self.encoder_net(self.init_embedding(instances))

    def encode_with_hidden(self, instances):
        """(embeddings, the last layer's input) for Embedding-Glimpse."""
        return self.encoder_net(self.init_embedding(instances), return_hidden=True)

    def change_embeddings(self, h_old: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """The last encoder layer rerun on ``h_old`` with the key mask ``attn_mask``."""
        return self.encoder_net(h_old, mask=attn_mask, h_old=h_old)

    def precompute_path(self, embeddings: torch.Tensor, path: int) -> PrecomputedCache:
        proj = getattr(self, f"project_node_embeddings_{path}")(embeddings)
        gk, gv, lk = (t.contiguous() for t in proj.chunk(3, dim=-1))
        graph_context = getattr(self, f"project_fixed_contexts_{path}")(embeddings.mean(dim=-2))
        return PrecomputedCache(node_embeddings=embeddings, graph_context=graph_context,
                                glimpse_key=gk, glimpse_val=gv, logit_key=lk)

    def decode_step(self, cache, state, mask, num_repeats: int = 1, path: int = 0):
        if num_repeats != 1:
            raise ValueError("MDAM decodes one query per instance (as in JAX)")
        query = getattr(self, f"context_embeddings_{path}")(cache.node_embeddings, state)
        return getattr(self, f"pointers_{path}")(
            query + cache.graph_context, cache.glimpse_key, cache.glimpse_val,
            cache.logit_key, mask)

    def path(self, p: int) -> "PathDecoder":
        """A view whose `decode_step` is path ``p``'s, for `rollout_from_cache`."""
        return PathDecoder(self, p)


class PathDecoder:
    """One path of an `MDAMPolicy` as a single-path policy: the shared
    encoder, the path's cache and decode step."""

    def __init__(self, policy: MDAMPolicy, path: int):
        self.policy, self.path = policy, path

    def encode(self, instances):
        return self.policy.encode(instances)

    def precompute(self, embeddings):
        return self.policy.precompute_path(embeddings, self.path)

    def decode_step(self, cache, state, mask, num_repeats: int = 1):
        return self.policy.decode_step(cache, state, mask, num_repeats, self.path)


def rollout_eg(policy: MDAMPolicy, env, instances, cache: PrecomputedCache,
               h_old: torch.Tensor, spec: DecodeSpec, path: int,
               generator: Optional[torch.Generator] = None) -> RolloutOutput:
    """Path ``path``'s rollout with Embedding-Glimpse: segments of
    ``eg_step_gap`` steps; before each later segment the last encoder layer
    reruns on ``h_old`` keyed on the current action mask and the path's
    cache is rebuilt. One trajectory per instance."""
    t_steps = env.max_steps
    gap = max(1, min(policy.eg_step_gap, t_steps))
    state = env.reset(instances)
    actions, logprobs = [], []
    for t in range(t_steps):
        if t > 0 and t % gap == 0:
            emb = policy.change_embeddings(h_old, env.action_mask(state))
            cache = policy.precompute_path(emb, path)
        mask = env.action_mask(state)
        logits = policy.decode_step(cache, state, mask, 1, path)
        lp_all = process_logits_spec(logits.float(), mask, spec)
        action, logprob = decode_action(lp_all, mask, spec, generator)
        logprobs.append(torch.where(state.done, 0.0, logprob))
        actions.append(action)
        state = env.step(state, action)
    actions = torch.stack(actions, dim=1)
    logprobs = torch.stack(logprobs, dim=1)
    reward = env.reward(state, actions)
    return RolloutOutput(reward=reward, log_likelihood=logprobs.sum(-1), actions=actions,
                         logprobs=logprobs, entropy=torch.zeros_like(reward))


class MDAM(REINFORCE):
    """MDAM's training: REINFORCE per path with the path's batch mean as
    baseline, minus ``kl_coef`` times the pairwise KL of the first step's
    path policies. The baseline argument is ignored (`NoBaseline`, as the
    JAX module sets whatever it is given)."""

    data_parallel = False  # its loss takes batch means of its own

    def __init__(self, env, policy: MDAMPolicy, kl_coef: float = 0.01, baseline=None,
                 **kwargs):
        super().__init__(env, policy, baseline=NoBaseline(), **kwargs)
        self.kl_coef = kl_coef

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """``replay_actions [P, B, T]``: each path's actions to replay
        (``kind="evaluate"``) where it would draw its own."""
        policy: MDAMPolicy = self.policy
        instances = instances_to_device(instances, self.device)
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
            replay_actions = torch.as_tensor(replay_actions).to(self.device)
        emb = policy.encode(instances)
        state0 = self.env.reset(instances)
        mask0 = self.env.action_mask(state0)
        rewards, lls, first_logprobs = [], [], []
        for p in range(policy.num_paths):
            cache = policy.precompute_path(emb, p)
            out = rollout_from_cache(policy.path(p), self.env, instances, cache, spec,
                                     self.generator,
                                     None if replay_actions is None else replay_actions[p])
            rewards.append(out.reward)
            lls.append(out.log_likelihood)
            logits0 = policy.decode_step(cache, state0, mask0, 1, p)
            first_logprobs.append(process_logits_spec(logits0.float(), mask0, spec))
        reward = torch.stack(rewards, dim=1)                      # [B, P]
        ll = torch.stack(lls, dim=1)
        advantage = reward - reward.mean(dim=0, keepdim=True)
        reinforce_loss = -(advantage * ll).mean()
        kl = torch.zeros((), device=reward.device)
        for i in range(policy.num_paths):
            for j in range(policy.num_paths):
                if i != j:
                    pi = first_logprobs[i].exp()
                    kl = kl + (pi * (first_logprobs[i] - first_logprobs[j])).sum(-1).mean()
        loss = reinforce_loss - self.kl_coef * kl
        metrics = {
            "loss": loss.detach(),
            "reinforce_loss": reinforce_loss.detach(),
            "kl_divergence": kl.detach(),
            "reward": reward.mean(),
            "max_reward": reward.max(dim=1).values.mean(),
        }
        return loss, (metrics, _PathRewards(reward.mean(dim=1)))

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        spec = spec or self.val_spec
        policy: MDAMPolicy = self.policy
        use_eg = policy.eg_step_gap < self.env.max_steps

        def eval_step(instances) -> dict:
            r = self.path_rewards(instances, spec, use_eg)
            return {"reward": r.mean(), "max_reward": r.max(dim=1).values.mean()}

        return eval_step

    def path_rewards(self, instances, spec: Optional[DecodeSpec] = None,
                     use_eg: Optional[bool] = None) -> torch.Tensor:
        """Every path's rewards ``[B, P]`` without a graph (Embedding-Glimpse
        where ``eg_step_gap`` is below the episode length)."""
        spec = spec or self.val_spec
        policy: MDAMPolicy = self.policy
        if use_eg is None:
            use_eg = policy.eg_step_gap < self.env.max_steps
        instances = instances_to_device(instances, self.device)
        with torch.no_grad():
            if use_eg:
                emb, h_old = policy.encode_with_hidden(instances)
            else:
                emb, h_old = policy.encode(instances), None
            rewards = []
            for p in range(policy.num_paths):
                cache = policy.precompute_path(emb, p)
                if use_eg:
                    out = rollout_eg(policy, self.env, instances, cache, h_old, spec, p,
                                     self.generator)
                else:
                    out = rollout_from_cache(policy.path(p), self.env, instances, cache,
                                             spec, self.generator)
                rewards.append(out.reward)
        return torch.stack(rewards, dim=1)


@dataclasses.dataclass
class _PathRewards:
    """What `REINFORCE.update` reads of a rollout: the reward (paths' mean)."""

    reward: torch.Tensor
