"""Asymmetric TSP environment (counterpart of `rl4co_tpu/envs/routing/atsp.py`).

An instance is a cost matrix ``[N, N]`` (row: from, column: to) with a zero
diagonal. The generator draws it uniform in ``[min_dist, max_dist)`` and,
for the TMAT class, closes it under the min-plus product (Floyd-Warshall),
which enforces the triangle inequality. Episode: exactly ``num_loc`` steps;
mask = unvisited nodes; reward = minus the sum of the directed arcs of the
closed tour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import xla_cpu_sum


@dataclasses.dataclass
class ATSPState:
    cost_matrix: torch.Tensor   # [B, N, N]
    first_node: torch.Tensor    # int64 [B]
    current_node: torch.Tensor  # int64 [B]
    visited: torch.Tensor       # bool [B, N]
    i: torch.Tensor             # int64 [B]
    done: torch.Tensor          # bool [B]


def tmat_closure(dm: torch.Tensor) -> torch.Tensor:
    """The min-plus closure of ``dm [..., N, N]``: for every intermediate
    node i in order, ``dm = min(dm, dm[:, i] + dm[i, :])`` (the JAX
    generator's `fori_loop`; each entry is one f32 add and a minimum, so the
    result is JAX's to the bit)."""
    for i in range(dm.shape[-1]):
        dm = torch.minimum(dm, dm[..., :, i, None] + dm[..., None, i, :])
    return dm


@dataclasses.dataclass(frozen=True)
class ATSP(Env):
    name = "atsp"
    num_loc: int = 10
    min_dist: float = 0.0
    max_dist: float = 1.0
    tmat_class: bool = True

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Instances from ``generator`` (its own stream, not `jax.random`'s)."""
        device = resolve_device(device)
        n = self.num_loc
        u = torch.rand((batch_size, n, n), generator=generator, device=device)
        dm = u * (self.max_dist - self.min_dist) + self.min_dist
        dm = dm * (1.0 - torch.eye(n, device=device))
        if self.tmat_class:
            dm = tmat_closure(dm)
        return {"cost_matrix": dm}

    def reset(self, instances: Instance) -> ATSPState:
        dm = instances["cost_matrix"]
        b, dev = dm.shape[0], dm.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return ATSPState(
            cost_matrix=dm,
            first_node=zeros,
            current_node=zeros.clone(),
            visited=torch.zeros((b, self.num_loc), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: ATSPState, action: torch.Tensor) -> ATSPState:
        action = action.long()
        frozen = state.done
        visited = state.visited.scatter(1, action[:, None], True)
        return ATSPState(
            cost_matrix=state.cost_matrix,
            first_node=torch.where(frozen | (state.i != 0), state.first_node, action),
            current_node=torch.where(frozen, state.current_node, action),
            visited=torch.where(frozen[:, None], state.visited, visited),
            i=torch.where(frozen, state.i, state.i + 1),
            done=torch.where(frozen, state.done, visited.all(dim=-1)),
        )

    def action_mask(self, state: ATSPState) -> torch.Tensor:
        mask = ~state.visited
        pad = torch.zeros_like(mask).scatter(1, state.current_node[:, None], True)
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: ATSPState, actions: torch.Tensor) -> torch.Tensor:
        """Minus the directed arcs of the tour, the closing one included,
        summed in XLA's CPU order (`xla_cpu_sum`)."""
        acts = actions[:, : self.num_loc].long()
        nxt = torch.roll(acts, -1, dims=-1)
        rows = torch.gather(state.cost_matrix, 1,
                            acts[:, :, None].expand(-1, -1, self.num_loc))
        arcs = torch.gather(rows, 2, nxt[:, :, None])[..., 0]
        return -xla_cpu_sum(arcs)

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        return self.num_loc

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.num_loc]
        if not (np.sort(actions, axis=-1) == np.arange(self.num_loc)).all():
            raise AssertionError("Invalid tour")
