"""DACT, the Dual-Aspect Collaborative Transformer (Ma et al. 2021), the
improvement policy of the 2-opt MDP (counterpart of
`rl4co_tpu/models/zoo/dact.py`).

- Encoder: a node-feature and a cyclic-positional aspect, each attending
  with its own scores and also taking the other aspect's attention pattern.
- Decoder: max-pooled graph context, two multi-head compatibilities and an
  MLP over their 2H per-pair features give N x N pair logits.
- Action: one categorical over the flattened pairs, the self-pairs and the
  previous action's pair masked; ``a // N, a % N``.

Sub-modules carry the Flax module's names (``layer_{i}/dac_att/W_query_node``,
``value_head/Dense_0``, ...), so that `convert.load_params` takes its tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec, decode_action, process_logits
from rl4co_tpu_torch.models.nn.env_embeddings.init import TSPInitEmbedding
from rl4co_tpu_torch.models.nn.ops import MLP, Normalization
from rl4co_tpu_torch.models.nn.pos_embeddings import pos_init_embedding
from rl4co_tpu_torch.utils.device import resolve_device


def head_scale(head_dim: int) -> float:
    """``1 / sqrt(head_dim)`` in f32, as the JAX package computes it."""
    return torch.tensor(head_dim, dtype=torch.float32).sqrt().reciprocal().item()


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, D] -> [B, H, N, D/H]"""
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads).transpose(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, W] -> [B, N, H*W]"""
    x = x.transpose(-2, -3)
    return x.reshape(*x.shape[:-2], -1)


class DACAttention(nn.Module):
    """Collaborative dual-aspect attention."""

    NAMES = ("W_query_node", "W_key_node", "W_query_pos", "W_key_pos", "W_val_node_self",
             "W_val_node_cross", "W_val_pos_self", "W_val_pos_cross")

    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        for name in self.NAMES:
            self.add_module(name, nn.Linear(embed_dim, embed_dim, bias=False))
        self.W_out_node = nn.Linear(2 * embed_dim, embed_dim, bias=False)
        self.W_out_pos = nn.Linear(2 * embed_dim, embed_dim, bias=False)

    def forward(self, h_node, h_pos):
        hn = self.num_heads
        q_node, k_node, q_pos, k_pos = (split_heads(getattr(self, n)(x), hn) for n, x in (
            ("W_query_node", h_node), ("W_key_node", h_node), ("W_query_pos", h_pos),
            ("W_key_pos", h_pos)))
        v_node_self, v_node_cross = (split_heads(getattr(self, n)(h_node), hn)
                                     for n in ("W_val_node_self", "W_val_node_cross"))
        v_pos_self, v_pos_cross = (split_heads(getattr(self, n)(h_pos), hn)
                                   for n in ("W_val_pos_self", "W_val_pos_cross"))
        scale = head_scale(q_node.shape[-1])
        attn_node = torch.softmax(q_node @ k_node.transpose(-1, -2) * scale, dim=-1)
        attn_pos = torch.softmax(q_pos @ k_pos.transpose(-1, -2) * scale, dim=-1)
        heads_node = torch.cat([attn_node @ v_node_self, attn_pos @ v_node_cross], dim=-1)
        heads_pos = torch.cat([attn_node @ v_pos_cross, attn_pos @ v_pos_self], dim=-1)
        return self.W_out_node(merge_heads(heads_node)), self.W_out_pos(merge_heads(heads_pos))


class DACTEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4, feedforward_hidden: int = 64,
                 normalization: str = "layer"):
        super().__init__()
        self.dac_att = DACAttention(embed_dim, num_heads)
        for name in ("norm_a1", "norm_a2", "norm_f1", "norm_f2"):
            self.add_module(name, Normalization(embed_dim, normalization))
        self.ff_node = MLP(embed_dim, embed_dim, (feedforward_hidden,))
        self.ff_pos = MLP(embed_dim, embed_dim, (feedforward_hidden,))

    def forward(self, h_node, h_pos):
        a_node, a_pos = self.dac_att(h_node, h_pos)
        h_node = self.norm_a1(h_node + a_node)
        h_pos = self.norm_a2(h_pos + a_pos)
        h_node = self.norm_f1(h_node + self.ff_node(h_node))
        h_pos = self.norm_f2(h_pos + self.ff_pos(h_pos))
        return h_node, h_pos


class DACTPolicy(nn.Module):
    """Encoder and pair decoder; `dact_act` takes one improvement step."""

    DECODER = ("project_graph_node", "project_graph_pos", "project_node_node",
               "project_node_pos", "compat_node_q", "compat_node_k", "compat_pos_q",
               "compat_pos_k")

    def __init__(self, embed_dim: int = 64, num_heads: int = 4, num_encoder_layers: int = 3,
                 feedforward_hidden: int = 64, normalization: str = "layer",
                 pos_type: str = "CPE", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_encoder_layers = num_encoder_layers
        self.init_embedding = TSPInitEmbedding(embed_dim)
        self.pos_embedding = pos_init_embedding(pos_type, embed_dim)
        for i in range(num_encoder_layers):
            self.add_module(f"layer_{i}", DACTEncoderLayer(embed_dim, num_heads,
                                                          feedforward_hidden, normalization))
        for name in self.DECODER:
            self.add_module(name, nn.Linear(embed_dim, embed_dim, bias=False))
        self.value_head = MLP(2 * num_heads, 1, (32, 32))
        self.to(device)

    def encode(self, state):
        h_node = self.init_embedding({"locs": state.locs})
        h_pos = self.pos_embedding(state)
        for i in range(self.num_encoder_layers):
            h_node, h_pos = getattr(self, f"layer_{i}")(h_node, h_pos)
        return h_node, h_pos

    def embeds(self, state) -> torch.Tensor:
        """What the critic reads: both aspects, ``[B, N, 2D]``."""
        return torch.cat(self.encode(state), dim=-1)

    def _compat(self, x, q_proj, k_proj):
        hd = self.embed_dim // self.num_heads
        q = q_proj(x).reshape(*x.shape[:-1], self.num_heads, hd)
        k = k_proj(x).reshape(*x.shape[:-1], self.num_heads, hd)
        compat = q.transpose(1, 2) @ k.permute(0, 2, 3, 1)          # [B, H, N, N]
        return compat.permute(0, 2, 3, 1) * head_scale(hd)          # [B, N, N, H]

    def forward(self, state):
        """(pair logits ``[B, N, N]``, embeds ``[B, N, 2D]``)."""
        nfe, pfe = self.encode(state)
        h_node = self.project_node_node(nfe) + self.project_graph_node(
            nfe.max(dim=-2).values)[:, None, :]
        h_pos = self.project_node_pos(pfe) + self.project_graph_pos(
            pfe.max(dim=-2).values)[:, None, :]
        compat = torch.cat([self._compat(h_pos, self.compat_pos_q, self.compat_pos_k),
                            self._compat(h_node, self.compat_node_q, self.compat_node_k)],
                           dim=-1)
        logits = self.value_head(head_scale(self.embed_dim) * compat)[..., 0]
        return logits, torch.cat([nfe, pfe], dim=-1)


def pair_mask(prev_action: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    """Feasible pairs ``[B, N, N]``: no self-pair, and not the previous
    action's pair either way round."""
    mask = ~torch.eye(n, dtype=torch.bool, device=device).expand(b, n, n)
    if prev_action is not None:
        nodes = torch.arange(n, device=device)
        oh0 = nodes == prev_action[:, :1]
        oh1 = nodes == prev_action[:, 1:2]
        pair = (oh0[:, :, None] & oh1[:, None, :]) | (oh1[:, :, None] & oh0[:, None, :])
        mask = mask & ~pair
    return mask


def dact_act(policy: DACTPolicy, state, spec: DecodeSpec,
             generator: Optional[torch.Generator] = None,
             prev_action: Optional[torch.Tensor] = None,
             replay_action: Optional[torch.Tensor] = None):
    """One step: pair logits, the masked flat categorical, the pair.
    Returns (action ``[B, 2]``, log-probability ``[B]``, embeds ``[B, N, 2D]``)."""
    logits, embeds = policy(state)
    b, n, _ = logits.shape
    flat_mask = pair_mask(prev_action, b, n, logits.device).reshape(b, n * n)
    logprobs = process_logits(logits.reshape(b, n * n).float(), flat_mask,
                              temperature=spec.temperature, tanh_clipping=spec.tanh_clipping)
    flat_replay = (replay_action[:, 0] * n + replay_action[:, 1]
                   if replay_action is not None else None)
    a, logprob = decode_action(logprobs, flat_mask, spec, generator, flat_replay)
    return torch.stack([a // n, a % n], dim=-1), logprob, embeds


class ImprovementCritic(nn.Module):
    """The value of a state from the improvement policy's embeds: mean-pooled
    graph and node projections, fused, meaned, then an MLP. ``embed_dim`` is
    the embeds' width (2 × DACT's, N2S's and NeuOpt's own)."""

    def __init__(self, embed_dim: int, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.project_graph = nn.Linear(embed_dim, embed_dim, bias=False)
        self.project_node = nn.Linear(embed_dim, embed_dim, bias=False)
        self.mlp = MLP(embed_dim, 1, (embed_dim, embed_dim // 2))
        self.to(device)

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        graph = self.project_graph(embeds.mean(dim=-2))
        fusion = self.project_node(embeds) + graph[:, None, :]
        return self.mlp(fusion.mean(dim=-2))[..., 0]


def DACT(env=None, policy: Optional[DACTPolicy] = None, policy_kwargs: Optional[dict] = None,
         device="cuda", **kwargs):
    """DACT with n-step PPO on the 2-opt env (`TSPkopt(k_max=2)` by default);
    returns an `NStepPPO`."""
    from rl4co_tpu_torch.envs.routing.tsp_kopt import TSPkopt
    from rl4co_tpu_torch.rl.n_step_ppo import NStepPPO

    env = env or TSPkopt(k_max=2)
    policy = policy or DACTPolicy(**{"device": device, **(policy_kwargs or {})})
    return NStepPPO(env=env, policy=policy, act_fn=dact_act, action_dim=2, **kwargs)
