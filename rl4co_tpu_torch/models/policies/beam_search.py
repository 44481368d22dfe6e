"""Beam search decoding (counterpart of `rl4co_tpu/models/policies/beam_search.py`).

Keeps the W partial solutions of highest log-probability per instance. The
beam state (env state, action history, per-step log-probabilities) is
gathered by parent index inside the loop, so no backtracking pass is needed.

Layout: flat beams are repeat-major ``[W*B]`` like multistart, and the
decoder cache stays untiled ``[B, ...]``: the W beams of an instance are the
grouped pointer step's query axis, one launch of ``pointer_step_grouped``
per decode step (``pointer_step_single`` when W is 1). An env with a dynamic
embedding (SDVRP) tiles the cache per beam instead and decodes one query per
row through ``pointer_step_single``.

Which W of the ``W·A`` candidates survive is decided as `jax.lax.top_k`
decides it: by value, ties to the lower flat index. At step 0 only beam 0 is
live (the others start at -inf), so when W exceeds the feasible actions the
ties among masked and dead candidates decide which junk beams exist;
`top_k_lower_index_first` takes the first W of a stable descending sort,
which breaks every tie that way on any device (`torch.topk` promises no
order among ties).
"""

from __future__ import annotations

import torch

from rl4co_tpu_torch.decoding import DecodeSpec, process_logits_spec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import DYNAMIC_EMBEDDING_REGISTRY
from rl4co_tpu_torch.models.policies.constructive import RolloutOutput, select_best as _select_best
from rl4co_tpu_torch.utils.ops import tree_map, batchify


def top_k_lower_index_first(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row of
    ``x``, in descending order, equal values by ascending index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_search_rollout(
    policy,
    env: Env,
    instances: dict,
    beam_width: int,
    spec: DecodeSpec = DecodeSpec(kind="greedy"),
    select_best: bool = True,
) -> RolloutOutput:
    """Beam search of width ``beam_width`` over ``instances`` ``[B, ...]`` (on
    the policy's device). Returns ``[W*B]`` repeat-major beams, or with
    ``select_best`` the best beam of each instance ``[B]``. The logits go
    through ``spec``'s processing (tanh clipping, temperature, ...); its
    ``kind`` is not used."""
    w = beam_width
    b = next(iter(instances.values())).shape[0]
    t_steps, a = env.max_steps, env.num_actions
    cache = policy.precompute(policy.encode(instances))
    decode_repeats = w
    if env.name in DYNAMIC_EMBEDDING_REGISTRY:  # per-beam K/V: a tiled cache
        cache, decode_repeats = batchify(cache, w), 1
    state = env.reset(batchify(instances, w))  # [W*B]
    device = state.done.device

    def flat_to_grouped(x):  # [W*B, ...] -> [B, W, ...]
        return x.reshape(w, b, *x.shape[1:]).transpose(0, 1)

    def grouped_to_flat(x):  # [B, W, ...] -> [W*B, ...]
        return x.transpose(0, 1).reshape(w * b, *x.shape[2:])

    def gather_beam(tree, parent):  # parent [B, W]: indices into the beam axis
        def take(x):
            xg = flat_to_grouped(x)
            idx = parent.reshape(b, w, *(1,) * (xg.ndim - 2)).expand(-1, -1, *xg.shape[2:])
            return grouped_to_flat(torch.gather(xg, 1, idx))

        return tree_map(take, tree)

    # only beam 0 is live at first, so that copies of one action do not
    # fill the beam at step 0
    beam_lp = torch.full((b, w), -torch.inf, device=device)
    beam_lp[:, 0] = 0.0
    actions = torch.zeros((w * b, 0), dtype=torch.long, device=device)
    logprobs = torch.zeros((w * b, 0), device=device)
    for _ in range(t_steps):
        mask = env.action_mask(state)
        logits = policy.decode_step(cache, state, mask, decode_repeats)
        step_lp = process_logits_spec(logits.float(), mask, spec)
        # done beams: only the padding action stays viable, at log-probability 0
        step_lp = torch.where(state.done[:, None],
                              torch.where(mask, 0.0, -torch.inf), step_lp)
        total = flat_to_grouped(step_lp) + beam_lp[..., None]            # [B, W, A]
        beam_lp, top_idx = top_k_lower_index_first(total.reshape(b, w * a), w)
        parent = top_idx // a
        action_g = top_idx % a                                            # [B, W]

        state = gather_beam(state, parent)
        actions = gather_beam(actions, parent)
        logprobs = gather_beam(logprobs, parent)
        # the chosen action's step log-probability under its parent beam
        parent_lp = torch.gather(flat_to_grouped(step_lp), 1,
                                 parent[..., None].expand(-1, -1, a))     # [B, W, A]
        chosen_lp = torch.gather(parent_lp, 2, action_g[..., None])[..., 0]
        step_logprob = torch.where(state.done, 0.0, grouped_to_flat(chosen_lp))
        action = grouped_to_flat(action_g)
        actions = torch.cat([actions, action[:, None]], dim=1)
        logprobs = torch.cat([logprobs, step_logprob[:, None]], dim=1)
        state = env.step(state, action)

    reward = env.reward(state, actions)
    out = RolloutOutput(reward=reward, log_likelihood=logprobs.sum(dim=-1), actions=actions,
                        logprobs=logprobs, entropy=torch.zeros_like(reward))
    return _select_best(out, w) if select_best else out
