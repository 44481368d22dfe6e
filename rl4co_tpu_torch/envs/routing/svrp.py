"""Skill VRP (counterpart of `rl4co_tpu/envs/routing/svrp.py`).

Technicians of ascending skill tour one after the other: a depot visit hands
over to the next one. A customer may be served only by a technician whose
skill covers its requirement, and every requirement is drawn below the best
technician's skill. Reward: minus the sum over legs of each leg's length
times the cost rate of the technician who drives it (``tech_costs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import gather_by_index


@dataclasses.dataclass
class SVRPState:
    locs: torch.Tensor          # [B, N+1, 2], depot at 0
    techs: torch.Tensor         # [B, num_tech], ascending skill levels
    skills: torch.Tensor        # [B, N], required skill per customer
    current_node: torch.Tensor  # int64 [B]
    current_tech: torch.Tensor  # int64 [B]
    visited: torch.Tensor       # bool [B, N+1]
    i: torch.Tensor             # int64 [B]
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class SVRP(Env):
    name = "svrp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    min_skill: float = 1.0
    max_skill: float = 10.0
    num_tech: int = 3
    tech_costs: tuple = (1.0, 2.0, 3.0)

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depot; technicians' skills uniform in
        ``[min_skill, max_skill)``, sorted; each customer's requirement
        uniform below the best technician's skill. Draws from ``generator``."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        locs = self.min_loc + span * rand(batch_size, self.num_loc, 2)
        depot = self.min_loc + span * rand(batch_size, 2)
        techs = torch.sort(self.min_skill + (self.max_skill - self.min_skill)
                           * rand(batch_size, self.num_tech), dim=-1).values
        skills = rand(batch_size, self.num_loc) * techs[:, -1:]
        return {"locs": locs, "depot": depot, "techs": techs, "skills": skills}

    def reset(self, instances: Instance) -> SVRPState:
        locs = torch.cat([instances["depot"][:, None, :], instances["locs"]], dim=1)
        b, dev = locs.shape[0], locs.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return SVRPState(
            locs=locs, techs=instances["techs"], skills=instances["skills"],
            current_node=zeros, current_tech=zeros.clone(),
            visited=torch.zeros((b, self.num_loc + 1), dtype=torch.bool, device=dev),
            i=zeros.clone(), done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: SVRPState, action: torch.Tensor) -> SVRPState:
        action = action.long()
        visited = state.visited.scatter(1, action[:, None], True)
        new = dataclasses.replace(
            state,
            current_node=action,
            current_tech=(state.current_tech + (action == 0).long()).clamp(0, self.num_tech),
            visited=visited,
            i=state.i + 1,
            done=visited.all(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: SVRPState) -> torch.Tensor:
        tech = state.current_tech.clamp(0, self.num_tech - 1)
        cur_skill = torch.gather(state.techs, 1, tech[:, None])
        mask_loc = state.visited[:, 1:] | (state.skills > cur_skill)   # True = infeasible
        unserved = (~mask_loc).any(dim=-1)
        mask_depot = (((state.current_node == 0) | (state.current_tech >= self.num_tech - 1))
                      & unserved)
        feasible = torch.cat([~mask_depot[:, None], ~mask_loc], dim=-1)
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, feasible)

    def reward(self, state: SVRPState, actions: torch.Tensor) -> torch.Tensor:
        actions = actions.long()
        go_from = torch.cat([torch.zeros_like(actions[:, :1]), actions], dim=1)
        go_to = torch.roll(go_from, -1, dims=1)
        dists = torch.linalg.vector_norm(
            gather_by_index(state.locs, go_to) - gather_by_index(state.locs, go_from), dim=-1)
        # the technician of each leg: one more after each return to the depot
        tech = (torch.cumsum((go_from == 0).long(), dim=1) - 1).clamp(0, self.num_tech - 1)
        costs = torch.tensor(self.tech_costs, dtype=dists.dtype, device=dists.device)
        return -(dists * costs[tech.clamp(max=len(self.tech_costs) - 1)]).sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_loc + 1

    @property
    def max_steps(self) -> int:
        return self.num_loc + self.num_tech + 1

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer once, each by a technician skilled enough. One
        instance (``[T]``) or a batch (``[B, T]``)."""
        actions = to_numpy(actions)
        techs, skills = to_numpy(instance["techs"]), to_numpy(instance["skills"])
        if actions.ndim == 1:
            actions, techs, skills = actions[None], techs[None], skills[None]
        n = self.num_loc
        s = np.sort(actions, axis=-1)
        if not ((s[:, -n:] == np.arange(1, n + 1)).all() and (s[:, :-n] == 0).all()):
            raise AssertionError("Invalid tour")
        for row, acts in enumerate(actions):
            tech = 0
            for a in acts:
                if a == 0:
                    tech = min(tech + 1, self.num_tech - 1)
                elif skills[row, a - 1] > techs[row, tech] + 1e-6:
                    raise AssertionError("Technician lacks required skill")
