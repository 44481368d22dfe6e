"""Facility Location Problem environment (counterpart of
`rl4co_tpu/envs/graph/flp.py`).

Choose ``to_choose`` facilities among ``num_loc`` points, minimising the sum
of each point's distance to its nearest chosen facility. The state carries
each point's running minimum distance (one `minimum` per step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import get_distance_matrix


@dataclasses.dataclass
class FLPState:
    locs: torch.Tensor            # [B, N, 2]
    orig_distances: torch.Tensor  # [B, N, N]
    distances: torch.Tensor       # [B, N] running minimum distance to the chosen set
    chosen: torch.Tensor          # bool [B, N]
    to_choose: torch.Tensor       # int64 [B]
    i: torch.Tensor               # int64 [B]
    done: torch.Tensor            # bool [B]

    @property
    def current_node(self) -> torch.Tensor:
        # no meaningful current node
        return torch.zeros_like(self.i)


@dataclasses.dataclass(frozen=True)
class FLP(Env):
    name = "flp"
    num_loc: int = 100
    min_loc: float = 0.0
    max_loc: float = 1.0
    to_choose: int = 10

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Points uniform in ``[min_loc, max_loc)`` from ``generator``."""
        device = resolve_device(device)
        u = torch.rand((batch_size, self.num_loc, 2), generator=generator, device=device,
                       dtype=torch.float32)
        return {"locs": self.min_loc + (self.max_loc - self.min_loc) * u}

    def reset(self, instances: Instance) -> FLPState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        max_dist = math.sqrt(2.0) * (self.max_loc - self.min_loc)
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return FLPState(
            locs=locs,
            orig_distances=get_distance_matrix(locs),
            distances=torch.full((b, self.num_loc), max_dist, dtype=torch.float32, device=dev),
            chosen=torch.zeros((b, self.num_loc), dtype=torch.bool, device=dev),
            to_choose=torch.full((b,), self.to_choose, dtype=torch.long, device=dev),
            i=zeros,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: FLPState, action: torch.Tensor) -> FLPState:
        action = action.long()
        row = torch.gather(state.orig_distances, 1,
                           action[:, None, None].expand(-1, 1, self.num_loc))[:, 0]
        return freeze_done(dataclasses.replace(
            state,
            chosen=state.chosen.scatter(1, action[:, None], True),
            distances=torch.minimum(state.distances, row),
            i=state.i + 1,
            done=state.i >= state.to_choose - 1,
        ), state)

    def action_mask(self, state: FLPState) -> torch.Tensor:
        pad = torch.zeros_like(state.chosen)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, ~state.chosen)

    def reward(self, state: FLPState, actions: torch.Tensor) -> torch.Tensor:
        return -state.distances.sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        return self.to_choose

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.to_choose]
        for row in actions.reshape(-1, actions.shape[-1]):
            if len(np.unique(row)) != self.to_choose:
                raise AssertionError("Duplicate facilities")
