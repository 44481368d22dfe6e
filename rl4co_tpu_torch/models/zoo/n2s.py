"""N2S, Neural Neighborhood Search for pickup and delivery (Ma et al. 2022;
counterpart of `rl4co_tpu/models/zoo/n2s.py`): the Synth-Attention encoder,
a removal decoder scoring each pickup-delivery pair from its neighbours in
the linked list and the recent removals, and a reinsertion decoder scoring
(first, second) position pairs. Trains with n-step PPO on `PDPRuinRepair`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec, decode_action, process_logits
from rl4co_tpu_torch.envs.routing.pdp_ruin_repair import reinsertion_mask
from rl4co_tpu_torch.models.nn.attention import MultiHeadCompat
from rl4co_tpu_torch.models.nn.ops import MLP
from rl4co_tpu_torch.models.zoo.n2s_encoder import N2SEncoder
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import gather_by_index, inverse_permutation


class NodePairRemovalDecoder(nn.Module):
    def __init__(self, embed_dim: int = 128, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.W_Q = nn.Linear(embed_dim, embed_dim, bias=False)
        self.W_K = nn.Linear(embed_dim, embed_dim, bias=False)
        self.agg = MLP(2 * num_heads + 4, 1, (32, 32))

    def forward(self, h, state):
        b, gs, d = h.shape
        hn = self.num_heads
        rec = state.rec_current
        pre = inverse_permutation(rec)
        post = torch.gather(rec, 1, rec)
        q, k = self.W_Q(h), self.W_K(h)
        q_pre = gather_by_index(q, pre).reshape(b, gs, hn, d // hn)
        k_post = gather_by_index(k, post).reshape(b, gs, hn, d // hn)
        q, k = q.reshape(b, gs, hn, d // hn), k.reshape(b, gs, hn, d // hn)
        compat = ((q_pre * k).sum(-1) + (q * k_post).sum(-1)
                  - (q_pre * k_post).sum(-1))[:, 1:, :]                   # [B, gs-1, H]
        half = gs // 2
        compat_pair = torch.cat([compat[:, :half], compat[:, half:]], dim=-1)
        record = state.action_record
        recent = torch.cat([record[:, -3:], record.mean(dim=1, keepdim=True)], dim=1)
        feats = torch.cat([compat_pair, recent.movedim(1, 2).to(compat_pair.dtype)], dim=-1)
        return self.agg(feats)[..., 0]                                     # [B, half]


class NodePairReinsertionDecoder(nn.Module):
    def __init__(self, embed_dim: int = 128, num_heads: int = 4):
        super().__init__()
        self.compater_insert1 = MultiHeadCompat(embed_dim, num_heads)
        self.compater_insert2 = MultiHeadCompat(embed_dim, num_heads)
        self.agg = MLP(4 * num_heads, 1, (32, 32))

    def forward(self, h, state, action_removal):
        b, gs, d = h.shape
        pickup = 1 + action_removal
        h_pickup = gather_by_index(h, pickup)[:, None, :]
        h_delivery = gather_by_index(h, pickup + gs // 2)[:, None, :]
        h_next = gather_by_index(h, state.rec_current)
        c1, c2 = self.compater_insert1, self.compater_insert2

        def scores(compat):                       # [H, B, 1, gs] -> [B, gs, H]
            return compat[:, :, 0, :].movedim(0, -1)

        pick_pre, pick_post = scores(c1(h_pickup, h)), scores(c2(h_pickup, h_next))
        del_pre, del_post = scores(c1(h_delivery, h)), scores(c2(h_delivery, h_next))
        hn = pick_pre.shape[-1]
        shape = (b, gs, gs, hn)
        feats = torch.cat([pick_pre[:, :, None].expand(shape), pick_post[:, :, None].expand(shape),
                           del_pre[:, None].expand(shape), del_post[:, None].expand(shape)],
                          dim=-1)
        return self.agg(feats)[..., 0]                                     # [B, gs, gs]


class N2SPolicy(nn.Module):
    def __init__(self, embed_dim: int = 128, num_heads: int = 4, num_encoder_layers: int = 3,
                 feedforward_hidden: int = 128, normalization: str = "layer",
                 pos_type: str = "CPE", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.encoder = N2SEncoder(embed_dim, num_heads, num_encoder_layers, feedforward_hidden,
                                  normalization, pos_type)
        self.removal_decoder = NodePairRemovalDecoder(embed_dim, num_heads)
        self.reinsertion_decoder = NodePairReinsertionDecoder(embed_dim, num_heads)
        self.to(device)

    def encode(self, state) -> torch.Tensor:
        return self.encoder(state)

    embeds = encode


def n2s_act(policy: N2SPolicy, state, spec: DecodeSpec,
            generator: Optional[torch.Generator] = None,
            prev_action: Optional[torch.Tensor] = None,
            replay_action: Optional[torch.Tensor] = None):
    """One step: a pair to remove, then the masked (first, second) position
    pair. Returns (action ``[B, 3]``, log-probability ``[B]``, embeds
    ``[B, gs, D]``)."""
    h = policy.encode(state)
    b, gs, _ = h.shape
    half = gs // 2
    mask1 = torch.ones(b, half, dtype=torch.bool, device=h.device)
    if prev_action is not None:
        mask1 = mask1 & (torch.arange(half, device=h.device) != prev_action[:, :1])
    lp1 = process_logits(policy.removal_decoder(h, state).float(), mask1,
                         temperature=spec.temperature, tanh_clipping=spec.tanh_clipping)
    a_removal, logp1 = decode_action(lp1, mask1, spec, generator,
                                     replay_action[:, 0] if replay_action is not None else None)
    re_logits = policy.reinsertion_decoder(h, state, a_removal)
    flat_mask = reinsertion_mask(state.visited_time, a_removal + 1).reshape(b, gs * gs)
    lp2 = process_logits(re_logits.reshape(b, gs * gs).float(), flat_mask,
                         temperature=spec.temperature, tanh_clipping=spec.tanh_clipping)
    flat_replay = (replay_action[:, 1] * gs + replay_action[:, 2]
                   if replay_action is not None else None)
    a_flat, logp2 = decode_action(lp2, flat_mask, spec, generator, flat_replay)
    return torch.stack([a_removal, a_flat // gs, a_flat % gs], dim=-1), logp1 + logp2, h


def N2S(env=None, policy: Optional[N2SPolicy] = None, policy_kwargs: Optional[dict] = None,
        device="cuda", **kwargs):
    """N2S with n-step PPO on `PDPRuinRepair`; returns an `NStepPPO`."""
    from rl4co_tpu_torch.envs.routing.pdp_ruin_repair import PDPRuinRepair
    from rl4co_tpu_torch.models.zoo.dact import ImprovementCritic
    from rl4co_tpu_torch.rl.n_step_ppo import NStepPPO

    env = env or PDPRuinRepair()
    policy = policy or N2SPolicy(**{"device": device, **(policy_kwargs or {})})
    if kwargs.get("critic") is None:
        kwargs["critic"] = ImprovementCritic(policy.embed_dim, device=next(
            policy.parameters()).device)
    return NStepPPO(env=env, policy=policy, act_fn=n2s_act, action_dim=3, **kwargs)
