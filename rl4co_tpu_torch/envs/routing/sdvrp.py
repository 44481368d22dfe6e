"""Split-Delivery VRP (counterpart of `rl4co_tpu/envs/routing/sdvrp.py`).

CVRP where a customer may be visited more than once, each visit delivering
``min(remaining demand, remaining capacity)``. The remaining demands
(``demand_with_depot``, the depot's slot 0) change at every step, so the
policy reads them through the SDVRP dynamic embedding
(`models/nn/env_embeddings/dynamic.py`): the decoder's K/V/logit keys are
new at every step and the cache is tiled per repeat. A customer is feasible
while it has demand left and the vehicle is not full; the episode ends when
no demand is left, and a finished row takes the depot until the trip count
(3N) is spent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Instance
from rl4co_tpu_torch.envs.routing.cvrp import CVRP
from rl4co_tpu_torch.envs.routing.op import freeze_done


@dataclasses.dataclass
class SDVRPState:
    locs: torch.Tensor               # [B, N+1, 2], depot at 0
    demand: torch.Tensor             # [B, N], the original demands
    demand_with_depot: torch.Tensor  # [B, N+1], remaining demands (depot slot 0)
    used_capacity: torch.Tensor      # f32 [B]
    current_node: torch.Tensor       # int64 [B]
    i: torch.Tensor                  # int64 [B]
    done: torch.Tensor               # bool [B]


@dataclasses.dataclass(frozen=True)
class SDVRP(CVRP):
    name = "sdvrp"

    def reset(self, instances: Instance) -> SDVRPState:
        base = super().reset(instances)
        demand = instances["demand"]
        return SDVRPState(
            locs=base.locs, demand=demand,
            demand_with_depot=torch.cat([torch.zeros_like(demand[:, :1]), demand], dim=1),
            used_capacity=base.used_capacity, current_node=base.current_node,
            i=base.i, done=base.done,
        )

    def step(self, state: SDVRPState, action: torch.Tensor) -> SDVRPState:
        action = action.long()
        selected = torch.gather(state.demand_with_depot, 1, action[:, None])[:, 0]
        delivered = torch.minimum(selected, self.vehicle_capacity - state.used_capacity)
        remaining = state.demand_with_depot.scatter_add(1, action[:, None], -delivered[:, None])
        new = dataclasses.replace(
            state,
            demand_with_depot=remaining,
            used_capacity=torch.where(action == 0, 0.0, state.used_capacity + delivered),
            current_node=action,
            i=state.i + 1,
            done=~(remaining > 0).any(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: SDVRPState) -> torch.Tensor:
        mask_loc = ((state.demand_with_depot[:, 1:] == 0)
                    | (state.used_capacity >= self.vehicle_capacity)[:, None])
        unserved = (~mask_loc).any(dim=-1)
        mask_depot = (state.current_node == 0) & unserved
        feasible = torch.cat([~mask_depot[:, None], ~mask_loc], dim=-1)
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, feasible)

    @property
    def max_steps(self) -> int:
        # every customer visit either finishes a customer (at most N) or fills
        # the vehicle (at most the total demand, under N/3 with the capacity
        # table), each possibly followed by a depot visit: 3N bounds it
        return 3 * self.num_loc

    def check_solution_validity(self, instance, actions) -> None:
        """All demand delivered under the capacity rules (1e-5 of slack).
        One instance (``[T]``) or a batch (``[B, T]``)."""
        actions = to_numpy(actions)
        if actions.ndim == 2:
            for row in range(actions.shape[0]):
                self.check_solution_validity({k: v[row] for k, v in instance.items()},
                                             actions[row])
            return
        demand = to_numpy(instance["demand"]).copy()
        cap, used = self.vehicle_capacity, 0.0
        for a in actions:
            if a == 0:
                used = 0.0
            else:
                d = min(demand[a - 1], cap - used)
                demand[a - 1] -= d
                used += d
                if used > cap + 1e-5:
                    raise AssertionError("Capacity exceeded")
        if not (demand <= 1e-5).all():
            raise AssertionError("Unserved demand remains")
