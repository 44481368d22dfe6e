"""L2D, Learning to Dispatch on FJSP and JSSP (counterpart of
`rl4co_tpu/models/zoo/l2d.py`).

- `L2DPolicy`: the schedule is re-encoded at every step by a bipartite
  operations <-> machines GNN over the dense eligibility matrix
  (`HetGNNLayer`); an MLP scores every (job, machine) pair, another the
  no-op; an optional critic head serves stepwise PPO.
- `L2DAttnPolicy`: MatNet-style dual operations <-> machines encoding of the
  processing-time matrix, run once per instance; per step each job's K, V
  and logit key are its next operation's plus `JSSPDynamicEmbedding`'s
  deltas, the queries are the machine embeddings shifted by their busy
  time, and the pointer's scores (an unmasked glimpse, so it computes
  through `pointer_logits`, as the JAX package's XLA path) are summed over
  machines: actions are [no-op, jobs].
- `L2DModel` / `L2DAttnModel`: REINFORCE with the batch mean as baseline,
  gradients clipped to norm 1, Adam.

No pointer kernel runs on these paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec, decode_action, process_logits_spec
from rl4co_tpu_torch.envs.scheduling.fjsp import op_is_ready
from rl4co_tpu_torch.models.nn.attention import MultiHeadAttention, PointerAttention
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import JSSPDynamicEmbedding
from rl4co_tpu_torch.models.nn.ops import MLP, Normalization, PositionalEncoding
from rl4co_tpu_torch.models.policies.constructive import RolloutOutput, instances_to_device
from rl4co_tpu_torch.models.zoo.matnet import MatNetLayer
from rl4co_tpu_torch.rl.reinforce import seeded_generator
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import gather_by_index
from rl4co_tpu_torch.utils.optim import get_optimizer


def op_features(state, scaling_factor: float) -> torch.Tensor:
    """Each operation's features ``[B, O, 5]``: mean processing time over its
    machines (scaled), readiness, number of eligible machines, its job, and
    whether it is scheduled."""
    proc = state.proc_times                                     # [B, M, O]
    eligible = (proc > 0).sum(1)
    mean_dur = proc.sum(1) / (eligible + 1e-9)
    return torch.stack([mean_dur / scaling_factor, op_is_ready(state).float(), eligible.float(),
                        state.ops_job_map.float(), state.op_scheduled.float()], dim=-1)


class HetGNNLayer(nn.Module):
    """Operations <-> machines message passing over ``adj [B, M, O]``: the
    machines take the mean of their eligible operations, then the operations
    the mean of their machines' new embeddings; each side adds a Dense of
    (itself, message) and normalises (``ma_up``/``ma_norm``,
    ``ops_up``/``ops_norm``)."""

    def __init__(self, embed_dim: int, normalization: str = "instance"):
        super().__init__()
        self.ma_up = nn.Linear(2 * embed_dim, embed_dim)
        self.ma_norm = Normalization(embed_dim, normalization)
        self.ops_up = nn.Linear(2 * embed_dim, embed_dim)
        self.ops_norm = Normalization(embed_dim, normalization)

    def forward(self, ops_emb, ma_emb, adj):
        ma_msg = (adj @ ops_emb) / (adj.sum(-1, keepdim=True) + 1e-9)
        ma_new = self.ma_norm(ma_emb + self.ma_up(torch.cat([ma_emb, ma_msg], dim=-1)))
        ops_msg = (adj.transpose(-1, -2) @ ma_new) / (adj.sum(-2)[..., None] + 1e-9)
        ops_new = self.ops_norm(ops_emb + self.ops_up(torch.cat([ops_emb, ops_msg], dim=-1)))
        return ops_new, ma_new


class L2DPolicy(nn.Module):
    """Stepwise encoder + (job, machine) actor, with a critic head for PPO
    (``with_critic``). ``forward(state) -> (logits [B, 1 + J*M], value [B] or
    None)``."""

    def __init__(self, embed_dim: int = 64, num_encoder_layers: int = 2,
                 normalization: str = "instance", actor_hidden_dim: int = 64,
                 scaling_factor: float = 100.0, with_critic: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d, h = embed_dim, actor_hidden_dim
        self.embed_dim, self.num_encoder_layers = d, num_encoder_layers
        self.scaling_factor = scaling_factor
        self.init_ops_embed = nn.Linear(5, d)
        self.init_ma_embed = nn.Linear(1, d)
        for i in range(num_encoder_layers):
            self.add_module(f"layer_{i}", HetGNNLayer(d, normalization))
        self.pool_proj = nn.Linear(2 * d, d)
        self.actor = MLP(3 * d, 1, (h, h))
        self.noop_head = MLP(d, 1, (h,))
        self.critic = MLP(d, 1, (h,)) if with_critic else None
        self.to(device)

    def forward(self, state):
        proc = state.proc_times
        b, m, _ = proc.shape
        j, d = state.next_op.shape[-1], self.embed_dim
        ops_emb = self.init_ops_embed(op_features(state, self.scaling_factor))
        ops_emb = torch.where(state.pad_mask[..., None], 0.0, ops_emb)
        busy_for = (state.busy_until - state.time[:, None]) / self.scaling_factor
        ma_emb = self.init_ma_embed(busy_for[..., None])
        adj = (proc > 0).float()
        for i in range(self.num_encoder_layers):
            ops_emb, ma_emb = getattr(self, f"layer_{i}")(ops_emb, ma_emb, adj)
        job_emb = gather_by_index(ops_emb, state.next_op)                     # [B, J, D]
        pooled_emb = self.pool_proj(torch.cat([ops_emb.mean(1), ma_emb.mean(1)], dim=-1))
        pair = torch.cat([job_emb[:, :, None, :].expand(b, j, m, d),
                          ma_emb[:, None, :, :].expand(b, j, m, d),
                          pooled_emb[:, None, None, :].expand(b, j, m, d)], dim=-1)
        pair_logits = self.actor(pair)[..., 0].reshape(b, j * m)
        logits = torch.cat([self.noop_head(pooled_emb), pair_logits], dim=-1)
        value = self.critic(pooled_emb)[..., 0] if self.critic is not None else None
        return logits, value


def _stepwise_rollout(step_logits, env, state, spec: DecodeSpec, generator=None,
                      replay_actions: Optional[torch.Tensor] = None):
    """The decode loop of both L2D policies: ``step_logits(state)`` at every
    one of ``env.max_steps`` steps. Returns (RolloutOutput, final state)."""
    actions, logprobs = [], []
    for t in range(env.max_steps):
        mask = env.action_mask(state)
        lp_all = process_logits_spec(step_logits(state).float(), mask, spec)
        replay_t = replay_actions[:, t] if replay_actions is not None else None
        action, logprob = decode_action(lp_all, mask, spec, generator, replay_t)
        logprobs.append(torch.where(state.done, 0.0, logprob))
        actions.append(action)
        state = env.step(state, action)
    actions = torch.stack(actions, dim=1)
    logprobs = torch.stack(logprobs, dim=1)
    reward = env.reward(state, actions)
    return RolloutOutput(reward=reward, log_likelihood=logprobs.sum(-1), actions=actions,
                         logprobs=logprobs, entropy=torch.zeros_like(reward)), state


def l2d_rollout(policy: L2DPolicy, env, instances, spec: DecodeSpec, generator=None,
                replay_actions: Optional[torch.Tensor] = None) -> RolloutOutput:
    """The stepwise rollout: the schedule re-encoded at every step."""
    out, _ = _stepwise_rollout(lambda s: policy(s)[0], env, env.reset(instances), spec,
                               generator, replay_actions)
    return out


class L2DAttnPolicy(nn.Module):
    """The encode-once attention variant of L2D (JSSP's pointer head)."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 8, num_encoder_layers: int = 4,
                 normalization: str = "batch", scaling_factor: float = 1000.0,
                 use_self_attention: bool = True, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d = embed_dim
        self.embed_dim, self.num_encoder_layers = d, num_encoder_layers
        self.scaling_factor, self.use_self_attention = scaling_factor, use_self_attention
        self.init_ops_embed = nn.Linear(5, d, bias=False)
        self.pos_encoder = PositionalEncoding(d)
        self.init_ma_embed = nn.Linear(1, d, bias=False)
        for i in range(num_encoder_layers):
            self.add_module(f"layer_{i}", MatNetLayer(d, num_heads, feedforward_hidden=2 * d,
                                                      normalization=normalization))
        if use_self_attention:
            for i in range(num_encoder_layers):
                self.add_module(f"ops_sa_{i}", MultiHeadAttention(d, num_heads, use_bias=False))
                self.add_module(f"ma_sa_{i}", MultiHeadAttention(d, num_heads, use_bias=False))
                self.add_module(f"ops_sa_norm_{i}", Normalization(d, normalization))
                self.add_module(f"ma_sa_norm_{i}", Normalization(d, normalization))
        self.project_kvl = nn.Linear(d, 3 * d, bias=False)
        self.proj_busy = nn.Linear(1, d, bias=False)
        self.pointer = PointerAttention(d, num_heads, impl="plain", mask_inner=False)
        self.dynamic_embedding = JSSPDynamicEmbedding(d, scaling_factor)
        self.dummy = nn.Parameter(torch.rand(1, d))
        self.to(device)

    def _busy_for(self, state):
        return ((state.busy_until - state.time[:, None]) / self.scaling_factor)[..., None]

    def encode(self, state) -> dict:
        """The reset state -> the decode cache."""
        ops_emb = self.pos_encoder(self.init_ops_embed(op_features(state, self.scaling_factor)),
                                   state.ops_seq_order)
        ops_emb = torch.where(state.pad_mask[..., None], 0.0, ops_emb)
        ma_emb = self.init_ma_embed(self._busy_for(state))
        dmat = state.proc_times.transpose(-1, -2) / self.scaling_factor      # [B, O, M]
        for i in range(self.num_encoder_layers):
            if self.use_self_attention:
                ops_emb = getattr(self, f"ops_sa_norm_{i}")(
                    ops_emb + getattr(self, f"ops_sa_{i}")(ops_emb))
                ma_emb = getattr(self, f"ma_sa_norm_{i}")(
                    ma_emb + getattr(self, f"ma_sa_{i}")(ma_emb))
            ops_emb, ma_emb = getattr(self, f"layer_{i}")(ops_emb, ma_emb, dmat)
        k, v, lk = self.project_kvl(ops_emb).chunk(3, dim=-1)
        return {"ops_emb": ops_emb, "ma_emb": ma_emb, "k": k, "v": v, "lk": lk}

    def decode_step(self, cache: dict, state, lbs, is_ready) -> torch.Tensor:
        """One step's logits ``[B, 1 + num_jobs]``."""
        ma_emb = cache["ma_emb"]
        b = ma_emb.shape[0]
        q = ma_emb + self.proj_busy(self._busy_for(state))                     # [B, M, D]
        k, v, lk = (gather_by_index(cache[name], state.next_op) for name in ("k", "v", "lk"))
        dk, dv, dl = self.dynamic_embedding(state, ma_emb, lbs, is_ready)
        k, v, lk = k + dk, v + dv, lk + dl
        lk = torch.cat([self.dummy[None].expand(b, 1, self.embed_dim), lk], dim=1)
        full = torch.ones((b, q.shape[1], lk.shape[1]), dtype=torch.bool, device=q.device)
        return self.pointer(q, k, v, lk, full).sum(dim=1)


def l2d_attn_rollout(policy: L2DAttnPolicy, env, instances, spec: DecodeSpec, generator=None,
                     replay_actions: Optional[torch.Tensor] = None) -> RolloutOutput:
    """Encode once at reset, then decode with the dynamic deltas."""
    state0 = env.reset(instances)
    cache = policy.encode(state0)
    out, _ = _stepwise_rollout(
        lambda s: policy.decode_step(cache, s, env.calc_lower_bound(s), env.op_is_ready(s)),
        env, state0, spec, generator, replay_actions)
    return out


class SchedulingAlgorithm:
    """What the L2D trainers share with the `Trainer`: the env, the policy and
    its device, Adam behind clipping by global norm, the random stream
    (reseeded by `reseed`), the step count, greedy evaluation, checkpoints.
    Subclasses give `update(instances, ...)` and `rollout(instances, spec)`."""

    def __init__(self, env, policy: nn.Module, lr: float, grad_clip: float,
                 train_spec: DecodeSpec):
        self.env, self.policy, self.train_spec = env, policy, train_spec
        self.device = next(policy.parameters()).device
        self.optimizer = get_optimizer(policy.parameters(), "adam", lr, grad_clip=grad_clip)
        self.step = 0
        self.generator = seeded_generator(self.device, 0)

    def reseed(self, *words: int) -> None:
        self.generator = seeded_generator(self.device, *words)

    def train_step(self, batch_size: int) -> dict:
        return self.update(self.env.generate(batch_size, self.generator, self.device))

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        spec = spec or DecodeSpec(kind="greedy")

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = self.rollout(instances_to_device(instances, self.device), spec)
            return {"reward": out.reward.mean(), "max_reward": out.reward.max()}

        return eval_step

    def epoch_end(self, host: dict) -> dict:
        return host

    def state_dict(self) -> dict:
        return {"policy": self.policy.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


class L2DModel(SchedulingAlgorithm):
    """REINFORCE for `L2DPolicy`: advantage = reward - batch mean."""

    rollout_fn = staticmethod(l2d_rollout)

    def __init__(self, env, policy: L2DPolicy, lr: float = 1e-4, grad_clip: float = 1.0,
                 train_spec: DecodeSpec = DecodeSpec(kind="sampling")):
        super().__init__(env, policy, lr, grad_clip, train_spec)

    def rollout(self, instances, spec: DecodeSpec, replay_actions=None) -> RolloutOutput:
        return self.rollout_fn(self.policy, self.env, instances, spec, self.generator,
                               replay_actions)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """``(loss, metrics)``; ``replay_actions [B, T]`` are replayed
        (``kind="evaluate"``) where the rollout would draw its own."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
            replay_actions = torch.as_tensor(replay_actions).to(self.device)
        out = self.rollout(instances_to_device(instances, self.device), spec, replay_actions)
        adv = out.reward - out.reward.mean()
        loss = -(adv * out.log_likelihood).mean()
        return loss, {"loss": loss.detach(), "reward": out.reward.mean()}

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None) -> dict:
        self.optimizer.zero_grad()
        loss, metrics = self.loss(instances, replay_actions)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return metrics


class L2DAttnModel(L2DModel):
    """REINFORCE for `L2DAttnPolicy` (encode once, dynamic deltas)."""

    rollout_fn = staticmethod(l2d_attn_rollout)
