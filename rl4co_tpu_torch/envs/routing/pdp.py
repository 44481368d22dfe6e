"""Pickup and Delivery Problem (counterpart of `rl4co_tpu/envs/routing/pdp.py`).

``num_loc`` is even: node 0 is the depot, ``1..n/2`` the pickups and
``n/2+1..n`` their deliveries, pickup ``p`` before delivery ``p + n/2``. A
delivery becomes available once its pickup is visited (``(a + n/2) mod
(n+1)``). The agent never selects the depot: the tour starts there, and the
reward closes it back there. A finished row repeats its current node.
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
from rl4co_tpu_torch.utils.ops import get_tour_length


@dataclasses.dataclass
class PDPState:
    locs: torch.Tensor          # [B, N+1, 2], depot at 0
    available: torch.Tensor     # bool [B, N+1], not visited yet
    to_deliver: torch.Tensor    # bool [B, N+1], pickups and the deliveries picked up
    current_node: torch.Tensor  # int64 [B]
    i: torch.Tensor             # int64 [B]
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class PDP(Env):
    name = "pdp"
    num_loc: int = 20  # even: num_loc / 2 pickup-delivery pairs
    min_loc: float = 0.0
    max_loc: float = 1.0

    def __post_init__(self):
        if self.num_loc % 2:
            raise ValueError(f"PDP needs an even num_loc, got {self.num_loc}")

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depot from ``generator``."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        locs = self.min_loc + span * torch.rand(
            (batch_size, self.num_loc, 2), generator=generator, device=device)
        depot = self.min_loc + span * torch.rand(
            (batch_size, 2), generator=generator, device=device)
        return {"locs": locs, "depot": depot}

    def reset(self, instances: Instance) -> PDPState:
        locs = torch.cat([instances["depot"][:, None, :], instances["locs"]], dim=1)
        b, dev, half = locs.shape[0], locs.device, self.num_loc // 2
        available = torch.ones((b, self.num_loc + 1), dtype=torch.bool, device=dev)
        available[:, 0] = False
        to_deliver = torch.zeros_like(available)
        to_deliver[:, : half + 1] = True
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return PDPState(locs=locs, available=available, to_deliver=to_deliver,
                        current_node=zeros, i=zeros.clone(),
                        done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: PDPState, action: torch.Tensor) -> PDPState:
        action = action.long()
        delivery = (action + self.num_loc // 2) % (self.num_loc + 1)
        available = state.available.scatter(1, action[:, None], False)
        new = PDPState(
            locs=state.locs,
            available=available,
            to_deliver=state.to_deliver.scatter(1, delivery[:, None], True),
            current_node=action,
            i=state.i + 1,
            done=~available.any(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: PDPState) -> torch.Tensor:
        mask = state.available & state.to_deliver
        pad = torch.zeros_like(mask).scatter(1, state.current_node[:, None], True)
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: PDPState, actions: torch.Tensor) -> torch.Tensor:
        idx = actions[:, : self.num_loc].long()
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
        return self.num_loc

    # multistart: the base class's starts, ``0..num_actions-1``, as the JAX
    # package has them (the depot and the deliveries among them)

    def check_solution_validity(self, instance, actions) -> None:
        """Every node once, each pickup before its delivery. One instance
        (``[T]``) or a batch (``[B, T]``)."""
        actions = to_numpy(actions)[..., : self.num_loc]
        n, half = self.num_loc, self.num_loc // 2
        if not (np.sort(actions, axis=-1) == np.arange(1, n + 1)).all():
            raise AssertionError("Invalid tour")
        pos = np.argsort(actions, axis=-1)  # pos[..., j]: the step of node j + 1
        if not (pos[..., :half] < pos[..., half:]).all():
            raise AssertionError("A delivery before its pickup")
