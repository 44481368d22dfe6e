"""Capacitated Vehicle Routing Problem environment (counterpart of
`rl4co_tpu/envs/routing/cvrp.py`).

Node 0 is the depot; customers are ``1..num_loc``. Demands are normalized by
vehicle capacity (so ``vehicle_capacity == 1.0``). Mask: a customer is
infeasible if already visited or its demand exceeds the remaining capacity
(with a slack of 1e-5); the depot is infeasible right after a depot visit
while customers remain. Episodes end when all customers and the depot have
been visited; afterwards the depot is the absorbing action (depot→depot arcs
add zero length, so the padded steps of the fixed trip count change no
reward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import get_tour_length

# vehicle capacity by number of customers (Kool et al. 2019's schedule)
CAPACITIES = {
    10: 20.0, 15: 25.0, 20: 30.0, 30: 33.0, 40: 37.0, 50: 40.0, 60: 43.0,
    75: 45.0, 100: 50.0, 125: 55.0, 150: 60.0, 200: 70.0, 500: 100.0,
    1000: 150.0,
}


def default_capacity(num_loc: int) -> float:
    """The table's capacity, or that of the nearest tabled size."""
    if num_loc in CAPACITIES:
        return CAPACITIES[num_loc]
    closest = min(CAPACITIES, key=lambda k: abs(k - num_loc))
    return CAPACITIES[closest]


@dataclasses.dataclass
class CVRPState:
    locs: torch.Tensor           # [B, N+1, 2], depot at 0
    demand: torch.Tensor         # [B, N], normalized by capacity
    used_capacity: torch.Tensor  # f32 [B]
    current_node: torch.Tensor   # int64 [B]
    visited: torch.Tensor        # bool [B, N+1], depot slot included
    i: torch.Tensor              # int64 [B], steps taken
    done: torch.Tensor           # bool [B]


@dataclasses.dataclass(frozen=True)
class CVRP(Env):
    name = "cvrp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    min_demand: int = 1
    max_demand: int = 10
    capacity: Optional[float] = None  # None: the table's
    vehicle_capacity: float = 1.0

    @property
    def _capacity(self) -> float:
        return self.capacity if self.capacity is not None else default_capacity(self.num_loc)

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depot; integer demands in ``[min_demand,
        max_demand)`` (1..9 by default) divided by the capacity. Draws come
        from ``generator`` (its own stream, not `jax.random`'s numbers)."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        locs = self.min_loc + span * torch.rand(
            (batch_size, self.num_loc, 2), generator=generator, device=device)
        depot = self.min_loc + span * torch.rand(
            (batch_size, 2), generator=generator, device=device)
        demand = torch.randint(self.min_demand, self.max_demand, (batch_size, self.num_loc),
                               generator=generator, device=device).float()
        return {"locs": locs, "depot": depot, "demand": demand / self._capacity}

    def reset(self, instances: Instance) -> CVRPState:
        locs = torch.cat([instances["depot"][:, None, :], instances["locs"]], dim=1)
        b, dev = locs.shape[0], locs.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return CVRPState(
            locs=locs,
            demand=instances["demand"],
            used_capacity=torch.zeros((b,), dtype=torch.float32, device=dev),
            current_node=zeros,
            visited=torch.zeros((b, self.num_loc + 1), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: CVRPState, action: torch.Tensor) -> CVRPState:
        action = action.long()
        customer = (action - 1).clamp(0, self.num_loc - 1)
        selected = torch.gather(state.demand, 1, customer[:, None])[:, 0]
        used = torch.where(action == 0, 0.0, state.used_capacity + selected)
        visited = state.visited.scatter(1, action[:, None], True)
        # absorbing once done: every field of a finished row keeps its value
        frozen = state.done
        return CVRPState(
            locs=state.locs,
            demand=state.demand,
            used_capacity=torch.where(frozen, state.used_capacity, used),
            current_node=torch.where(frozen, state.current_node, action),
            visited=torch.where(frozen[:, None], state.visited, visited),
            i=torch.where(frozen, state.i, state.i + 1),
            done=torch.where(frozen, state.done, visited.all(dim=-1)),
        )

    def action_mask(self, state: CVRPState) -> torch.Tensor:
        exceeds = state.demand + state.used_capacity[:, None] > self.vehicle_capacity + 1e-5
        mask_loc = state.visited[:, 1:] | exceeds                 # True = infeasible
        unserved = (~mask_loc).any(dim=-1)
        mask_depot = (state.current_node == 0) & unserved
        feasible = torch.cat([~mask_depot[:, None], ~mask_loc], dim=-1)
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True                                          # absorbing: depot only
        return torch.where(state.done[:, None], pad, feasible)

    def reward(self, state: CVRPState, actions: torch.Tensor) -> torch.Tensor:
        # the tour starts at the depot; trailing depot→depot pads add zero
        idx = actions.long()
        ordered = torch.cat([
            state.locs[:, :1],
            torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2)),
        ], dim=1)
        return -get_tour_length(ordered)

    @property
    def num_actions(self) -> int:
        return self.num_loc + 1

    @property
    def max_steps(self) -> int:
        # worst case alternates customer and depot
        return 2 * self.num_loc

    def get_num_starts(self) -> int:
        return self.num_loc  # every customer, never the depot

    def select_start_nodes(self, instances: Instance, num_starts: int) -> torch.Tensor:
        """Customers ``1..num_starts`` (not ``0..num_starts-1``: 0 is the depot)."""
        demand = instances["demand"]
        starts = torch.arange(1, num_starts + 1, dtype=torch.long, device=demand.device)
        return starts[None, :].expand(demand.shape[0], -1)

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer exactly once, and no route over capacity. Takes one
        instance (``actions [T]``) or a batch (``actions [..., T]``)."""
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        demand = instance["demand"]
        if isinstance(demand, torch.Tensor):
            demand = demand.detach().cpu().numpy()
        actions = np.asarray(actions)
        demand = np.asarray(demand, dtype=np.float64)
        n, cap = self.num_loc, self.vehicle_capacity
        sorted_pi = np.sort(actions, axis=-1)
        if not (sorted_pi[..., -n:] == np.arange(1, n + 1)).all():
            raise AssertionError("Invalid tour")
        if not (sorted_pi[..., :-n] == 0).all():
            raise AssertionError("Invalid tour (repeated customers)")
        # a depot visit refills: demand -capacity there, clamped at 0 below
        pad = np.full(demand.shape[:-1] + (1,), -cap)
        d = np.take_along_axis(np.concatenate([pad, demand], axis=-1), actions, axis=-1)
        used = np.zeros(actions.shape[:-1])
        for t in range(actions.shape[-1]):
            used = np.maximum(used + d[..., t], 0.0)
            if (used > cap + 1e-5).any():
                raise AssertionError("Used more than capacity")
