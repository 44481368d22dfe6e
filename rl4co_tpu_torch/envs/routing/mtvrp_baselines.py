"""Classical baselines for MTVRP, all 16 variants (counterpart of
`rl4co_tpu/envs/routing/mtvrp_baselines.py`; reference
`rl4co/envs/routing/mtvrp/baselines/solve.py:29-83`).

The default is a multistart nearest-feasible-neighbour construction over the
env's own action mask, so that one rollout handles every variant (open
routes, time windows, distance limits, backhauls) as the MDP defines it,
followed by best-of-S selection. ``solver="pyvrp" | "lkh" | "ortools"``
dispatches to the external solvers (`solver_adapters`), which raise
ImportError where their package is absent.
"""

from __future__ import annotations

from typing import Optional

import torch

from rl4co_tpu_torch.utils.ops import batchify, unbatchify


def greedy_solve(env, instances, num_samples: int = 16,
                 generator: Optional[torch.Generator] = None):
    """Multistart nearest-feasible-neighbour over the env's action mask, on
    the instances' device.

    Sample 0 is pure greedy (nearest feasible node, the depot behind a
    penalty of 0.1 while customers are feasible); samples 1.. perturb the
    distances by 0.05 · Gumbel noise from ``generator`` (default: seeded 0).
    Returns ``(actions [B, T], cost [B])`` with cost = −reward of the best
    sample.
    """
    instances = {k: torch.as_tensor(v) for k, v in instances.items()}
    device = instances["locs"].device
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    b, s = instances["locs"].shape[0], num_samples
    state = env.reset(batchify(instances, s))
    # sample index of each tiled row (repeat-major): row k*b + i -> sample k
    temp = torch.where(torch.arange(s, device=device).repeat_interleave(b) == 0, 0.0, 0.05)
    depot_penalty = torch.zeros(state.locs.shape[1], device=device)
    depot_penalty[0] = 0.1
    actions = []
    for _ in range(env.max_steps):
        mask = env.action_mask(state)                              # [S*B, N+1]
        rows = torch.arange(state.locs.shape[0], device=device)
        cur = state.locs[rows, state.current_node]
        d = torch.linalg.vector_norm(state.locs - cur[:, None, :], dim=-1)
        u = torch.rand(d.shape, generator=generator, device=device) * (1.0 - 1e-9) + 1e-9
        gumbel = -torch.log(-torch.log(u))
        score = -d + temp[:, None] * gumbel - depot_penalty
        score = torch.where(mask, score, -torch.inf)
        action = torch.argmax(score, dim=-1)
        state = env.step(state, action)
        actions.append(action)
    actions = torch.stack(actions, dim=1)                          # [S*B, T]
    reward_g = unbatchify(env.reward(state, actions), s)           # [B, S]
    best = torch.argmax(reward_g, dim=-1)
    best_actions = unbatchify(actions, s)[torch.arange(b, device=device), best]
    return best_actions, -reward_g.max(dim=-1).values


def solve(instances, max_runtime: float = 10.0, num_procs: int = 1, solver: str = "greedy",
          env=None, **kwargs):
    """``solver='greedy'`` (the default, `greedy_solve`; needs ``env``) or one
    of the external solvers. Returns ``(actions, costs)``."""
    if solver == "greedy":
        if env is None:
            raise ValueError("the greedy solver needs env= for its masks and reward")
        return greedy_solve(env, instances, **kwargs)
    from rl4co_tpu_torch.envs.routing.solver_adapters import SOLVERS, solve_batch

    if solver in SOLVERS:
        actions, rewards = solve_batch(instances, solver, max_runtime=max_runtime,
                                       num_procs=num_procs, **kwargs)
        return actions, -rewards   # the adapters return rewards
    raise ValueError(f"Unknown solver {solver!r}. Available: greedy, {SOLVERS}")
