"""NeuOpt (Ma et al. 2023), flexible k-opt (counterpart of
`rl4co_tpu/models/zoo/neuopt.py`): the N2S encoder and the recurrent
dual-stream (RDS) decoder. A k-opt move is chosen as k_max node selections
through two GRU streams, and stops early where a selection closes the cycle.
Works with `TSPkopt(k_max > 2)`.

The GRU cells are `torch.nn.GRUCell`s; the weight bridge packs Flax's
``ir, iz, in`` / ``hr, hz, hn`` into their stacked ``r, z, n`` rows (Flax's
``hr`` and ``hz`` have no bias: those rows of ``bias_hh`` are zero, and a
gradient hook keeps them so through training). Both
compute ``n = tanh(W_in x + b_in + r (W_hn h + b_hn))``, ``h' = (1 - z) n + z h``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec, decode_action, process_logits, take_along_last
from rl4co_tpu_torch.models.zoo.n2s_encoder import N2SEncoder
from rl4co_tpu_torch.utils.device import resolve_device


def _zero_rz_rows(grad: torch.Tensor) -> torch.Tensor:
    """The gradient of a GRU cell's ``bias_hh`` with its r and z rows zeroed."""
    d = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[:2 * d]), grad[2 * d:]])


class RDSDecoder(nn.Module):
    """Dual-stream additive attention scores."""

    def __init__(self, embed_dim: int = 128):
        super().__init__()
        d = embed_dim
        self.rnn1 = nn.GRUCell(d, d)
        self.rnn2 = nn.GRUCell(d, d)
        for cell in (self.rnn1, self.rnn2):
            # Flax's hr and hz have no bias: those rows stay zero, untrained
            with torch.no_grad():
                cell.bias_hh[:2 * d].zero_()
            cell.bias_hh.register_hook(_zero_rz_rows)
        self.linear_V1 = nn.Parameter(torch.empty(d).uniform_(0.0, 0.1))
        self.linear_V2 = nn.Parameter(torch.empty(d).uniform_(0.0, 0.1))
        for name in ("linear_K1", "linear_K2", "linear_K3", "linear_K4", "linear_Q1",
                     "linear_Q2", "linear_Q3", "linear_Q4"):
            self.add_module(name, nn.Linear(d, d, bias=False))

    def forward(self, h, q1, q2, input_q1, input_q2):
        q1 = self.rnn1(input_q1, q1)
        q2 = self.rnn2(input_q2, q2)
        mu = (self.linear_V1 * torch.tanh(
            self.linear_K1(h) + self.linear_Q1(q1)[:, None, :]
            + self.linear_K3(h) * self.linear_Q3(q1)[:, None, :])).sum(-1)
        lam = (self.linear_V2 * torch.tanh(
            self.linear_K2(h) + self.linear_Q2(q2)[:, None, :]
            + self.linear_K4(h) * self.linear_Q4(q2)[:, None, :])).sum(-1)
        return mu + lam, q1, q2


class NeuOptPolicy(nn.Module):
    """Encoder and RDS decoder; `neuopt_act` drives the k_max selections."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, num_encoder_layers: int = 3,
                 feedforward_hidden: int = 128, normalization: str = "layer",
                 pos_type: str = "CPE", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.encoder = N2SEncoder(embed_dim, num_heads, num_encoder_layers, feedforward_hidden,
                                  normalization, pos_type)
        self.decoder = RDSDecoder(embed_dim)
        self.init_hidden_W = nn.Linear(embed_dim, embed_dim)
        self.init_query = nn.Parameter(torch.empty(embed_dim).uniform_(0.0, 0.1))
        self.to(device)

    def encode(self, state) -> torch.Tensor:
        return self.encoder(state)

    embeds = encode

    def init_queries(self, h):
        init_q = self.init_query[None, :].expand(h.shape[0], -1)
        return init_q, self.init_hidden_W(h.mean(dim=1))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=idx.device) == idx[:, None]


def neuopt_act(policy: NeuOptPolicy, state, spec: DecodeSpec,
               generator: Optional[torch.Generator] = None,
               prev_action: Optional[torch.Tensor] = None,
               replay_action: Optional[torch.Tensor] = None, k_max: int = 4):
    """The k_max selections of a k-opt move. Returns (packed action
    ``[B, 3 k_max]``, log-probability ``[B]``, embeds ``[B, N, D]``). A row
    that has stopped takes its first node again, adds nothing to the
    log-probability, and keeps its ends."""
    h = policy.encode(state)
    b, gs, _ = h.shape
    dev = h.device
    init_q, init_hidden = policy.init_queries(h)
    q1 = q2 = init_hidden
    input_q1 = input_q2 = init_q
    rec, vt = state.rec_current, state.visited_time
    action_index = torch.zeros(b, k_max, dtype=torch.long, device=dev)
    k_left = torch.zeros(b, k_max + 1, dtype=torch.long, device=dev)
    k_right = torch.zeros(b, k_max, dtype=torch.long, device=dev)
    next_of_last = torch.full((b,), -1, dtype=torch.long, device=dev)
    mask = torch.zeros(b, gs, dtype=torch.bool, device=dev)   # True = forbidden
    stopped = torch.ones(b, dtype=torch.bool, device=dev)
    ll = torch.zeros(b, device=dev)
    bidx = torch.arange(b, device=dev)
    vt_tag = None
    for i in range(k_max):
        logits, q1, q2 = policy.decoder(h, q1, q2, input_q1, input_q2)
        if i == 0 and prev_action is not None:
            mask = mask | _one_hot(prev_action[:, 0], gs)
        feasible = ~mask
        logprobs = process_logits(logits.float(), feasible, temperature=spec.temperature,
                                  tanh_clipping=spec.tanh_clipping)
        a, logprob = decode_action(logprobs, feasible, spec, generator,
                                   replay_action[:, i] if replay_action is not None else None)
        if i > 0:
            a = torch.where(stopped, action_index[:, 0], a)
            ll = ll + torch.where(stopped, 0.0, take_along_last(logprobs, a))
        else:
            ll = ll + logprob
        next_of_new = rec[bidx, a]
        action_index[:, i] = a
        k_left[:, i] = torch.where(stopped, a, k_left[:, i])
        if i > 0:
            k_right[:, i - 1] = torch.where(~stopped, a, k_right[:, i - 1])
        k_left[:, i + 1] = next_of_new
        input_q1 = h[bidx, a]
        # floor-mod: a row with no last node (-1) reads node gs - 1, unused
        input_q2 = torch.where(stopped[:, None], input_q1, h[bidx, next_of_last % gs])
        newly_stopped = a == next_of_last
        stopped = newly_stopped if i == 0 else (stopped | newly_stopped)
        if i > 0:
            k_left[:, i] = torch.where(stopped, k_left[:, i - 1], k_left[:, i])
            k_right[:, i] = torch.where(stopped, k_right[:, i - 1], k_right[:, i])
        if i == 0:
            vt_tag = (vt - vt[bidx, a][:, None]) % gs
        mask = vt_tag <= vt_tag[bidx, a][:, None]
        if i == 0:
            mask = mask | (vt_tag > gs - 2)
        mask = mask & ~(_one_hot(a, gs) & stopped[:, None])
        allow_first = ~stopped & (next_of_new == action_index[:, 0])
        mask = mask & ~(_one_hot(action_index[:, 0], gs) & allow_first[:, None])
        next_of_last = torch.where(stopped, -1, next_of_new)
    k_right[:, -1] = torch.where(~stopped, k_left[:, -1], k_right[:, -1])
    return torch.cat([action_index, k_left[:, :k_max], k_right], dim=-1), ll, h


def NeuOpt(env=None, policy: Optional[NeuOptPolicy] = None,
           policy_kwargs: Optional[dict] = None, device="cuda", **kwargs):
    """NeuOpt with n-step PPO on `TSPkopt(k_max=4)` by default; returns an `NStepPPO`."""
    from rl4co_tpu_torch.envs.routing.tsp_kopt import TSPkopt
    from rl4co_tpu_torch.models.zoo.dact import ImprovementCritic
    from rl4co_tpu_torch.rl.n_step_ppo import NStepPPO

    env = env or TSPkopt(k_max=4)
    policy = policy or NeuOptPolicy(**{"device": device, **(policy_kwargs or {})})
    k_max = getattr(env, "k_max", 4)
    if kwargs.get("critic") is None:
        kwargs["critic"] = ImprovementCritic(policy.embed_dim, device=next(
            policy.parameters()).device)
    return NStepPPO(env=env, policy=policy, act_fn=functools.partial(neuopt_act, k_max=k_max),
                    action_dim=3 * k_max, **kwargs)
