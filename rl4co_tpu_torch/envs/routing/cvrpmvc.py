"""CVRP with a maximum number of vehicles, GLOP's CVRP variant (counterpart
of `rl4co_tpu/envs/routing/cvrpmvc.py`).

As CVRP, and the depot is masked besides while the vehicles not used yet
could no longer carry the demand that remains: at most ``ceil(total demand /
capacity) + 1`` vehicles. A customer is masked when its demand exceeds the
remaining capacity with no slack (CVRP's mask allows 1e-5).
"""

from __future__ import annotations

import dataclasses

import torch

from rl4co_tpu_torch.envs.base import Instance
from rl4co_tpu_torch.envs.routing.cvrp import CVRP
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.ops import xla_cpu_sum


@dataclasses.dataclass
class CVRPMVCState:
    locs: torch.Tensor              # [B, N+1, 2], depot at 0
    demand: torch.Tensor            # [B, N], normalized by capacity
    used_capacity: torch.Tensor     # f32 [B]
    vehicles_used: torch.Tensor     # int64 [B], the vehicle on the road counted
    demand_remaining: torch.Tensor  # f32 [B]
    max_vehicle: torch.Tensor       # f32 [B]
    current_node: torch.Tensor      # int64 [B]
    visited: torch.Tensor           # bool [B, N+1]
    i: torch.Tensor                 # int64 [B]
    done: torch.Tensor              # bool [B]


@dataclasses.dataclass(frozen=True)
class CVRPMVC(CVRP):
    name = "cvrpmvc"

    def reset(self, instances: Instance) -> CVRPMVCState:
        base = super().reset(instances)
        # the depot's rule compares this sum with whole vehicles, so its last
        # bit can decide the mask: summed in the JAX package's order
        demand_remaining = xla_cpu_sum(instances["demand"])
        return CVRPMVCState(
            locs=base.locs,
            demand=base.demand,
            used_capacity=base.used_capacity,
            vehicles_used=torch.ones_like(base.current_node),
            demand_remaining=demand_remaining,
            max_vehicle=torch.ceil(demand_remaining / self.vehicle_capacity) + 1,
            current_node=base.current_node,
            visited=base.visited,
            i=base.i,
            done=base.done,
        )

    def step(self, state: CVRPMVCState, action: torch.Tensor) -> CVRPMVCState:
        action = action.long()
        is_depot = action == 0
        customer = (action - 1).clamp(0, self.num_loc - 1)
        selected = torch.gather(state.demand, 1, customer[:, None])[:, 0]
        visited = state.visited.scatter(1, action[:, None], True)
        new = dataclasses.replace(
            state,
            current_node=action,
            used_capacity=torch.where(is_depot, 0.0, state.used_capacity + selected),
            vehicles_used=state.vehicles_used + (is_depot & (state.current_node != 0)).long(),
            demand_remaining=state.demand_remaining - torch.where(is_depot, 0.0, selected),
            visited=visited,
            i=state.i + 1,
            done=visited.all(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: CVRPMVCState) -> torch.Tensor:
        exceeds = state.demand + state.used_capacity[:, None] > self.vehicle_capacity
        mask_loc = state.visited[:, 1:] | exceeds                 # True = infeasible
        capacity_remaining = (state.max_vehicle - state.vehicles_used) * self.vehicle_capacity
        mask_depot = (((state.current_node == 0)
                       | (state.demand_remaining > capacity_remaining))
                      & ~mask_loc.all(dim=-1))
        feasible = torch.cat([~mask_depot[:, None], ~mask_loc], dim=-1)
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True                                          # absorbing: depot only
        return torch.where(state.done[:, None], pad, feasible)
