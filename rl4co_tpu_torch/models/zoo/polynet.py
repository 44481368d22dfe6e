"""PolyNet (Hottung et al. 2024): k diverse solution strategies from one
policy (counterpart of `rl4co_tpu/models/zoo/polynet.py`).

The pointer's glimpse is conditioned on one of k binary vectors, one per
sampled solution: the k samples of an instance are the grouped decode's
query axis L, and row l of the bit table (tiled over L) conditions query l.
Training uses the Poppy loss: only the best of the k rollouts of an
instance receives the REINFORCE gradient.

The pointer head calls the functional `pointer_logits` with its own
projection (``project_out``, then two poly layers on the glimpse and the
bit vector), as the JAX package does: the fused pointer kernel computes a
single ``[D, D]`` projection, so no decode step of PolyNet launches a kernel.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch
from torch import nn

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.nn.attention import pointer_logits, single_query
from rl4co_tpu_torch.models.policies.constructive import rollout
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy
from rl4co_tpu_torch.rl.baselines import SharedBaseline
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.ops import unbatchify


def bit_table(k: int) -> torch.Tensor:
    """The first ``k`` binary vectors of ``max(1, ceil(log2 k))`` bits, in
    counting order, as f32 rows ``[k, bits]``."""
    bits = max(1, math.ceil(math.log2(k)))
    return torch.tensor(list(itertools.product([0, 1], repeat=bits))[:k], dtype=torch.float32)


class PolyNetAttention(nn.Module):
    """Pointer head whose glimpse ``g = project_out(heads)`` becomes
    ``g + poly_layer_2(relu(poly_layer_1([g, z_l])))`` for query l, with
    ``z_l`` row ``l mod k`` of the bit table."""

    def __init__(self, k: int, embed_dim: int, poly_layer_dim: int = 256, num_heads: int = 8,
                 mask_inner: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.mask_inner = mask_inner
        self.register_buffer("bits", bit_table(k), persistent=False)
        self.poly_layer_1 = nn.Linear(embed_dim + self.bits.shape[1], poly_layer_dim)
        self.poly_layer_2 = nn.Linear(poly_layer_dim, embed_dim)
        self.project_out = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, query, glimpse_k, glimpse_v, logit_k, mask):
        def step(query, *args):
            b, num_solutions, _ = query.shape
            reps = -(-num_solutions // self.bits.shape[0])
            z = self.bits.repeat(reps, 1)[:num_solutions]                # [L, bits]
            z = z.to(query.dtype).expand(b, -1, -1)

            def project_with_poly(heads):
                glimpse = self.project_out(heads)
                poly = self.poly_layer_2(torch.relu(
                    self.poly_layer_1(torch.cat([glimpse, z], dim=-1))))
                return glimpse + poly

            return pointer_logits(query, *args, num_heads=self.num_heads,
                                  project_out=project_with_poly, mask_inner=self.mask_inner)

        return single_query(step, query, glimpse_k, glimpse_v, logit_k, mask)


class PolyNetPolicy(AttentionModelPolicy):
    """AM policy with the PolyNet pointer; ``pointer_impl`` does not apply."""

    def __init__(self, *args, k: int = 64, poly_layer_dim: int = 256, **kwargs):
        self.k = k
        self.poly_layer_dim = poly_layer_dim
        super().__init__(*args, **kwargs)

    def _make_pointer(self) -> nn.Module:
        return PolyNetAttention(self.k, self.embed_dim, self.poly_layer_dim, self.num_heads,
                                mask_inner=self.mask_inner)


class PolyNet(REINFORCE):
    """PolyNet: ``k`` sampled rollouts per instance, one per bit vector, with
    the Poppy best-only loss against the mean over the k. The train spec
    becomes sampling with ``num_samples=k`` and the baseline
    `SharedBaseline(num_repeats=k)`, whatever is passed. Without a
    ``policy``, `PolyNetPolicy(env.name, k=k, **policy_kwargs)`."""

    def __init__(self, env: Env, policy: Optional[PolyNetPolicy] = None, k: int = 64,
                 val_num_solutions: int = 64, policy_kwargs: Optional[dict] = None,
                 train_spec: DecodeSpec = DecodeSpec(kind="sampling"), **kwargs):
        if policy is None:
            policy = PolyNetPolicy(env_name=env.name, k=k, **(policy_kwargs or {}))
        self.k, self.val_num_solutions = k, val_num_solutions
        super().__init__(
            env, policy, baseline=SharedBaseline(num_repeats=k),
            train_spec=dataclasses.replace(train_spec, kind="sampling", num_samples=k,
                                           multistart=False),
            **kwargs)

    def loss(self, instances, replay_actions: Optional[torch.Tensor] = None):
        out = self.train_rollout(instances, replay_actions)
        reward = unbatchify(out.reward, self.k)                 # [B, k]
        ll = unbatchify(out.log_likelihood, self.k)
        advantage = reward - reward.mean(dim=-1, keepdim=True)
        # Poppy: the gradient flows through the best rollout(s) of each instance only
        best_mask = reward >= reward.max(dim=-1, keepdim=True).values
        loss = -(advantage * ll * best_mask).mean()
        metrics = {
            "loss": loss.detach(),
            "reward": reward.mean(),
            "max_reward": reward.max(dim=-1).values.mean(),
            "entropy": out.entropy.detach().mean(),
        }
        return loss, (metrics, out)

    def make_eval_step(self, spec: Optional[DecodeSpec] = None):
        s = self.val_num_solutions
        spec = spec or DecodeSpec(kind="sampling", num_samples=s,
                                  tanh_clipping=self.train_spec.tanh_clipping)

        def eval_step(instances) -> dict:
            with torch.no_grad():
                out = rollout(self.policy, self.env, instances, spec,
                              generator=self.generator, device=self.device)
            r = unbatchify(out.reward, s)
            return {"reward": r.mean(), "max_reward": r.max(dim=-1).values.mean()}

        return eval_step
