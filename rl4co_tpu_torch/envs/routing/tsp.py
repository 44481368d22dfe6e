"""Travelling Salesman Problem environment (counterpart of
`rl4co_tpu/envs/routing/tsp.py`).

Episode length is exactly ``num_loc`` steps. Action space: next city index
in ``[0, num_loc)``; mask = unvisited cities; reward = negative closed-tour
length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import get_tour_length


@dataclasses.dataclass
class TSPState:
    locs: torch.Tensor          # [B, N, 2]
    first_node: torch.Tensor    # int64 [B]
    current_node: torch.Tensor  # int64 [B]
    visited: torch.Tensor       # bool [B, N]
    i: torch.Tensor             # int64 [B], steps taken
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class TSP(Env):
    name = "tsp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    loc_distribution: str = "uniform"  # see rl4co_tpu_torch/envs/distributions.py

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Instances from ``generator`` (its own stream: the same seed does
        not give `jax.random`'s numbers): uniform in ``[min_loc, max_loc)``,
        or from `get_sampler(loc_distribution)` in its own range."""
        device = resolve_device(device)
        shape = (batch_size, self.num_loc, 2)
        if self.loc_distribution != "uniform":
            from rl4co_tpu_torch.envs.distributions import get_sampler

            return {"locs": get_sampler(self.loc_distribution).sample(shape, generator, device)}
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return {"locs": self.min_loc + (self.max_loc - self.min_loc) * u}

    def reset(self, instances: Instance) -> TSPState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return TSPState(
            locs=locs,
            first_node=zeros,
            current_node=zeros.clone(),
            visited=torch.zeros((b, self.num_loc), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: TSPState, action: torch.Tensor) -> TSPState:
        action = action.long()
        first_node = torch.where(state.i == 0, action, state.first_node)
        visited = state.visited.scatter(1, action[:, None], True)
        # Absorbing after done: rows that were done keep their old state, so
        # extra padded steps are no-ops (never triggered for TSP, where the
        # trip count equals num_loc).
        frozen = state.done
        return TSPState(
            locs=state.locs,
            first_node=torch.where(frozen, state.first_node, first_node),
            current_node=torch.where(frozen, state.current_node, action),
            visited=torch.where(frozen[:, None], state.visited, visited),
            i=torch.where(frozen, state.i, state.i + 1),
            done=torch.where(frozen, state.done, visited.all(dim=-1)),
        )

    def action_mask(self, state: TSPState) -> torch.Tensor:
        # After done, allow only the current node (absorbing padding action).
        mask = ~state.visited
        pad = torch.zeros_like(mask).scatter(1, state.current_node[:, None], True)
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: TSPState, actions: torch.Tensor) -> torch.Tensor:
        idx = actions[:, : self.num_loc].long()
        ordered = torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2))
        return -get_tour_length(ordered)

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        return self.num_loc

    def get_num_starts(self) -> int:
        return self.num_loc

    # select_start_nodes: every city is a start, the base class's arange

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.num_loc]
        sorted_pi = np.sort(actions, axis=-1)
        expected = np.arange(self.num_loc)
        if not (sorted_pi == expected).all():
            raise AssertionError("Invalid TSP tour (not a permutation)")


@dataclasses.dataclass(frozen=True)
class DenseRewardTSP(TSP):
    """TSP with a reward at every step (the JAX package's `DenseRewardTSP`,
    for stepwise PPO): minus the length of the arc just added, nothing at
    the first choice, and the closing arc back to the first node paid at the
    last step."""

    def step_with_reward(self, state: TSPState, action: torch.Tensor):
        """``(next state, reward [B])``; 0 on rows already done."""
        action = action.long()

        def loc(idx):
            return torch.gather(state.locs, 1, idx[:, None, None].expand(-1, 1, 2))[:, 0]

        cur = loc(action)
        arc = torch.linalg.vector_norm(cur - loc(state.current_node), dim=-1)
        arc = torch.where(state.i == 0, 0.0, arc)  # the first choice adds no arc
        next_state = self.step(state, action)
        closing = torch.where(next_state.done & ~state.done,
                              torch.linalg.vector_norm(cur - loc(next_state.first_node), dim=-1),
                              0.0)
        return next_state, torch.where(state.done, 0.0, -(arc + closing))
