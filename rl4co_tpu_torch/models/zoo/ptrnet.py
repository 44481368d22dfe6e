"""Pointer Network (Vinyals et al. 2015 / Bello et al. 2016), counterpart of
`rl4co_tpu/models/zoo/ptrnet.py`.

An LSTM encoder over the embedded nodes, an LSTM decoder whose first input is
the learned ``decoder_input0`` and whose next input is the *embedding* of the
node just chosen (not the LSTM's output), and a Bahdanau pointer
``v · tanh(W_q q + W_ref e)``. The decode loop is its own (the constructive
rollout assumes a decoder without state). Nothing here reaches a pointer
kernel: the LSTMs and the additive pointer are plain tensor operations, as
they are XLA operations in the JAX package.

Behaviours of the JAX package kept as they are:

- `ptrnet_rollout` never reads ``spec.compute_dtype``: under the train CLI's
  default ``bf16-mixed`` PtrNet trains in f32;
- the policy's own ``tanh_clipping`` is unused; the spec's is applied;
- the baseline is a moving average, fixed in `PointerNetworkModel`: the loss
  takes its value before the update (the batch mean on the first step),
  then it moves as ``0.8 · old + 0.2 · mean``. There is no other baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from rl4co_tpu_torch.decoding import (
    DecodeSpec,
    decode_action,
    get_log_likelihood,
    process_logits_spec,
)
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import RolloutOutput, instances_to_device
from rl4co_tpu_torch.rl.reinforce import seeded_generator
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import gather_by_index
from rl4co_tpu_torch.utils.optim import get_optimizer

GATES = "ifgo"


def _lecun_normal_(weight: torch.Tensor) -> None:
    """Flax's default kernel initialiser: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    std = weight.shape[1] ** -0.5 / 0.87962566
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: per gate (i, f, g, o) an input kernel
    without bias (``ii``, ``if``, ``ig``, ``io``) and a hidden kernel with
    bias (``hi``, ...), so one bias per gate, not `torch.nn.LSTMCell`'s two.
    The carry is ``(c, h)``, Flax's order."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(in_dim, hidden_dim, bias=False))
            self.add_module(f"h{g}", nn.Linear(hidden_dim, hidden_dim))
        for g in GATES:  # lecun normal, orthogonal, zeros: Flax's initialisers
            _lecun_normal_(getattr(self, f"i{g}").weight)
            nn.init.orthogonal_(getattr(self, f"h{g}").weight)
            nn.init.zeros_(getattr(self, f"h{g}").bias)

    def fused(self):
        """The four gates' kernels stacked once: ``(W_i [4H, in], W_h [4H, H],
        b_h [4H])``, differentiable; a rollout makes them once for all steps."""
        def cat(prefix, attr):
            return torch.cat([getattr(getattr(self, f"{prefix}{g}"), attr) for g in GATES])

        return cat("i", "weight"), cat("h", "weight"), cat("h", "bias")

    def forward(self, carry, x, fused=None):
        """One step: ``carry (c, h)``, ``x [B, in]`` -> ``((c', h'), h')``."""
        w_i, w_h, b_h = fused if fused is not None else self.fused()
        c, h = carry
        i, f, g, o = (F.linear(h, w_h, b_h) + F.linear(x, w_i)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class PointerNetwork(nn.Module):
    """Encoder + recurrent decoder pieces, exposed as separate methods.
    Parameter names are the JAX tree's (``embed``, ``enc_lstm``, ``dec_lstm``,
    ``W_q``, ``W_ref``, ``v``, ``decoder_input0``)."""

    def __init__(self, embed_dim: int = 128, hidden_dim: int = 128,
                 tanh_clipping: float = 10.0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.tanh_clipping = tanh_clipping  # unused, as in the JAX package
        self.embed = nn.Linear(2, embed_dim)
        self.enc_lstm = LSTMCell(embed_dim, hidden_dim)
        self.dec_lstm = LSTMCell(embed_dim, hidden_dim)
        self.W_q = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.W_ref = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.v = nn.Parameter(torch.rand(hidden_dim) * 0.2)
        self.decoder_input0 = nn.Parameter(torch.rand(embed_dim) * 0.2)
        for lin in (self.embed, self.W_q, self.W_ref):
            _lecun_normal_(lin.weight)
        nn.init.zeros_(self.embed.bias)
        self.to(device)

    def encode(self, locs: torch.Tensor):
        """``locs [B, N, 2]`` -> (embeddings ``[B, N, E]``, encoder outputs
        ``[B, N, H]``, the encoder's final carry ``(c, h)``)."""
        emb = self.embed(locs)
        b = emb.shape[0]
        zeros = emb.new_zeros((b, self.hidden_dim))
        carry, fused, outs = (zeros, zeros), self.enc_lstm.fused(), []
        for t in range(emb.shape[1]):
            carry, out = self.enc_lstm(carry, emb[:, t], fused)
            outs.append(out)
        return emb, torch.stack(outs, dim=1), carry

    def decode_step(self, dec_carry, dec_input, enc_outputs, mask=None, ref=None, fused=None):
        """One decoder step -> (scores ``[B, N]``, new carry). ``mask`` is not
        read (the logits are masked by the decoding); ``ref`` (``W_ref`` of the
        encoder outputs) and ``fused`` (the cell's stacked kernels) may be
        given once per rollout."""
        dec_carry, q = self.dec_lstm(dec_carry, dec_input, fused)
        if ref is None:
            ref = self.W_ref(enc_outputs)
        scores = torch.einsum("h,bnh->bn", self.v, torch.tanh(self.W_q(q)[:, None, :] + ref))
        return scores, dec_carry


PointerNetworkPolicy = PointerNetwork  # the name the reference exports the policy under


def ptrnet_rollout(
    policy: PointerNetwork,
    env: Env,
    instances,
    spec: DecodeSpec,
    generator: Optional[torch.Generator] = None,
    replay_actions: Optional[torch.Tensor] = None,
    device="cuda",
) -> RolloutOutput:
    """PtrNet's own decode loop over ``env.max_steps`` steps: greedy, sampling
    (draws from ``generator``) or evaluate (``replay_actions [B, T]``).
    Records the graph unless called under `torch.no_grad()`. f32 whatever
    ``spec.compute_dtype`` says, as in the JAX package."""
    device = resolve_device(device)
    instances = instances_to_device(instances, device)
    if replay_actions is not None:
        replay_actions = torch.as_tensor(replay_actions).to(device)
    emb, enc_outputs, carry = policy.encode(instances["locs"])
    ref, fused = policy.W_ref(enc_outputs), policy.dec_lstm.fused()
    dec_input = policy.decoder_input0[None, :].expand(emb.shape[0], -1)
    state = env.reset(instances)
    actions, logprobs_chosen = [], []
    entropy = torch.zeros_like(state.done, dtype=torch.float32)
    for t in range(env.max_steps):
        mask = env.action_mask(state)
        logits, carry = policy.decode_step(carry, dec_input, enc_outputs, mask, ref, fused)
        logprobs = process_logits_spec(logits.float(), mask, spec)
        replay_t = replay_actions[:, t] if replay_actions is not None else None
        action, logprob = decode_action(logprobs, mask, spec, generator, replay_t)
        probs = logprobs.exp()
        step_entropy = -torch.where(probs > 0, probs * logprobs, 0.0).sum(dim=-1)
        logprobs_chosen.append(torch.where(state.done, 0.0, logprob))
        entropy = entropy + torch.where(state.done, 0.0, step_entropy)
        actions.append(action)
        state = env.step(state, action)
        dec_input = gather_by_index(emb, action)
    actions = torch.stack(actions, dim=1)
    logprobs_chosen = torch.stack(logprobs_chosen, dim=1)
    return RolloutOutput(
        reward=env.reward(state, actions),
        log_likelihood=get_log_likelihood(logprobs_chosen),
        actions=actions,
        logprobs=logprobs_chosen,
        entropy=entropy,
    )


class PointerNetworkModel:
    """REINFORCE for PtrNet with Bello et al.'s moving-average baseline
    (no baseline object: the value is the algorithm's). Adam at ``lr``,
    gradients clipped to global norm ``grad_clip``. Runs where ``policy``
    lives."""

    def __init__(self, env: Env, policy: PointerNetwork, lr: float = 1e-4,
                 grad_clip: Optional[float] = 1.0,
                 train_spec: DecodeSpec = DecodeSpec(kind="sampling", tanh_clipping=10.0)):
        self.env = env
        self.policy = policy
        self.train_spec = train_spec
        self.device = next(policy.parameters()).device
        self.optimizer = get_optimizer(policy.parameters(), "adam", lr, grad_clip=grad_clip)
        # the moving average; NaN until the first step
        self.baseline_value = torch.full((), float("nan"), device=self.device)
        self.step = 0
        self.generator = seeded_generator(self.device, 0)

    def reseed(self, *words: int) -> None:
        """Restart the random stream from ``words`` (the trainer: seed, epoch)."""
        self.generator = seeded_generator(self.device, *words)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        """REINFORCE loss against the moving baseline's value before this
        step's update; records the graph. Returns ``(loss, (metrics, rollout
        output))``; with ``replay_actions`` the rollout replays those."""
        spec = self.train_spec
        if replay_actions is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        out = ptrnet_rollout(self.policy, self.env, instances, spec, self.generator,
                             replay_actions, device=self.device)
        mean = out.reward.mean()
        bl_val = torch.where(torch.isnan(self.baseline_value), mean, self.baseline_value)
        loss = -((out.reward - bl_val) * out.log_likelihood).mean()
        return loss, ({"loss": loss.detach(), "reward": mean}, out)

    def update(self, instances, replay_actions: Optional[torch.Tensor] = None) -> dict:
        """One optimisation step, then the baseline's move toward the batch mean."""
        self.optimizer.zero_grad()
        loss, (metrics, _) = self.loss(instances, replay_actions)
        loss.backward()
        self.optimizer.step()
        old, mean = self.baseline_value, metrics["reward"].detach()
        self.baseline_value = torch.where(torch.isnan(old), mean, 0.8 * old + 0.2 * mean)
        self.step += 1
        return metrics

    def train_step(self, batch_size: int) -> dict:
        """Generate a fresh batch on the device and `update` on it."""
        return self.update(self.env.generate(batch_size, self.generator, self.device))

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        spec = spec or DecodeSpec(kind="greedy", tanh_clipping=self.train_spec.tanh_clipping)

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = ptrnet_rollout(self.policy, self.env, instances, spec, self.generator,
                                     device=self.device)
            return {"reward": out.reward.mean(), "max_reward": out.reward.max()}

        return eval_step

    def epoch_end(self, host: dict) -> dict:
        return host

    def state_dict(self) -> dict:
        return {"policy": self.policy.state_dict(), "optimizer": self.optimizer.state_dict(),
                "baseline_value": self.baseline_value, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.baseline_value = state["baseline_value"].to(self.device)
        self.step = int(state["step"])
