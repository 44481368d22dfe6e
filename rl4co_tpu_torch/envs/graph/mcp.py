"""Maximum Coverage Problem environment (counterpart of
`rl4co_tpu/envs/graph/mcp.py`).

Choose ``n_sets_to_choose`` sets, maximising the total weight of the items
they cover. ``membership [B, num_sets, max_size]`` holds 1-based item ids
with 0 as padding; the state's ``covered [B, num_items + 1]`` is the target
of the members' scatter, its slot 0 absorbing the padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MCPState:
    membership: torch.Tensor   # int64 [B, S, M], 1-based item ids, 0 pad
    weights: torch.Tensor      # [B, I]
    covered: torch.Tensor      # bool [B, I + 1]; slot 0 = padding sink
    chosen: torch.Tensor       # bool [B, S]
    n_to_choose: torch.Tensor  # int64 [B]
    i: torch.Tensor            # int64 [B]
    done: torch.Tensor         # bool [B]

    @property
    def current_node(self) -> torch.Tensor:
        return torch.zeros_like(self.i)


@dataclasses.dataclass(frozen=True)
class MCP(Env):
    name = "mcp"
    num_items: int = 200
    num_sets: int = 100
    min_weight: int = 1
    max_weight: int = 10
    min_size: int = 5
    max_size: int = 15
    n_sets_to_choose: int = 10

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Integer weights (the floor of a uniform draw in ``[min_weight,
        max_weight)``), set sizes uniform in ``[min_size, max_size]`` and
        members uniform over the items, with repeats, from ``generator``."""
        device = resolve_device(device)
        u = torch.rand((batch_size, self.num_items), generator=generator, device=device,
                       dtype=torch.float32)
        weights = torch.floor(self.min_weight + (self.max_weight - self.min_weight) * u)
        weights = weights.clamp(self.min_weight, self.max_weight)
        sizes = torch.randint(self.min_size, self.max_size + 1, (batch_size, self.num_sets),
                              generator=generator, device=device)
        membership = torch.randint(1, self.num_items + 1,
                                   (batch_size, self.num_sets, self.max_size),
                                   generator=generator, device=device)
        valid = torch.arange(self.max_size, device=device) < sizes[..., None]
        return {"membership": torch.where(valid, membership, 0), "weights": weights}

    def reset(self, instances: Instance) -> MCPState:
        weights = instances["weights"]
        b, dev = weights.shape[0], weights.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return MCPState(
            membership=instances["membership"].long(),
            weights=weights,
            covered=torch.zeros((b, self.num_items + 1), dtype=torch.bool, device=dev),
            chosen=torch.zeros((b, self.num_sets), dtype=torch.bool, device=dev),
            n_to_choose=torch.full((b,), self.n_sets_to_choose, dtype=torch.long, device=dev),
            i=zeros,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: MCPState, action: torch.Tensor) -> MCPState:
        action = action.long()
        members = torch.gather(state.membership, 1, action[:, None, None].expand(
            -1, 1, state.membership.shape[-1]))[:, 0]                       # [B, M]
        return freeze_done(dataclasses.replace(
            state,
            chosen=state.chosen.scatter(1, action[:, None], True),
            covered=state.covered.scatter(1, members, True),
            i=state.i + 1,
            done=state.i >= state.n_to_choose - 1,
        ), state)

    def action_mask(self, state: MCPState) -> torch.Tensor:
        pad = torch.zeros_like(state.chosen)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, ~state.chosen)

    def reward(self, state: MCPState, actions: torch.Tensor) -> torch.Tensor:
        return (state.weights * state.covered[:, 1:]).sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_sets

    @property
    def max_steps(self) -> int:
        return self.n_sets_to_choose

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.n_sets_to_choose]
        for row in actions.reshape(-1, actions.shape[-1]):
            if len(np.unique(row)) != self.n_sets_to_choose:
                raise AssertionError("Duplicate sets")
