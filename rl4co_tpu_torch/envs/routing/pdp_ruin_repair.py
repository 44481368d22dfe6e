"""PDP ruin-and-repair improvement environment of N2S (counterpart of
`rl4co_tpu/envs/routing/pdp_ruin_repair.py`).

A solution is a linked list over ``num_loc + 1`` nodes: the depot 0, the
pickups 1..n/2 and their deliveries n/2+1..n. An action ``(pair, first,
second)`` removes the pickup-delivery pair ``pair + 1`` and reinserts the
pickup after node ``first`` and the delivery after node ``second``; the
reward of a step is the decrease of the best-so-far cost. ``action_record``
keeps the last removals, which N2S's removal decoder reads.
"""

from __future__ import annotations

import dataclasses

import torch

from rl4co_tpu_torch.envs.routing.tsp_kopt import (
    advance,
    check_linked_tour,
    compute_visited_time,
    linked_list_cost,
)
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import inverse_permutation, scatter_permutation


@dataclasses.dataclass
class PDPRRState:
    locs: torch.Tensor           # [B, N+1, 2], the depot first
    rec_current: torch.Tensor    # [B, N+1] linked list (int64)
    rec_best: torch.Tensor
    cost_current: torch.Tensor   # [B]
    cost_bsf: torch.Tensor       # [B]
    visited_time: torch.Tensor   # [B, N+1]
    action_record: torch.Tensor  # [B, history, N/2] f32
    i: torch.Tensor              # [B]


def ruin_repair_move(rec: torch.Tensor, pair_index: torch.Tensor, first: torch.Tensor,
                     second: torch.Tensor) -> torch.Tensor:
    """Remove pickup ``pair_index`` and its delivery, then reinsert the
    delivery after ``second`` and the pickup after ``first`` (all ``[B]``)."""
    half = rec.shape[-1] // 2
    rec = rec.clone()
    p, f, s = pair_index[:, None], first[:, None], second[:, None]
    # remove the pickup
    rec.scatter_(1, torch.gather(inverse_permutation(rec), 1, p), torch.gather(rec, 1, p))
    rec.scatter_(1, p, p)
    # remove the delivery
    d = p + half
    rec.scatter_(1, torch.gather(inverse_permutation(rec), 1, d), torch.gather(rec, 1, d))
    # the delivery after `second`, then the pickup after `first`
    post = torch.gather(rec, 1, s)
    rec.scatter_(1, s, d)
    rec.scatter_(1, d, post)
    post = torch.gather(rec, 1, f)
    rec.scatter_(1, f, p)
    rec.scatter_(1, p, post)
    return rec


def reinsertion_mask(visited_time: torch.Tensor, selected_node: torch.Tensor) -> torch.Tensor:
    """Feasible (first, second) positions ``[B, gs, gs]``: the pickup's
    position may not follow the delivery's, and neither attaches to the
    removed pair itself (``selected_node`` is the pickup, ``[B]``)."""
    gs = visited_time.shape[-1]
    vt = visited_time % gs
    order = vt[:, :, None] > vt[:, None, :]
    rows = torch.arange(gs, device=vt.device)
    hit = (rows == selected_node[:, None]) | (rows == selected_node[:, None] + gs // 2)
    return ~(order | hit[:, :, None] | hit[:, None, :])


@dataclasses.dataclass(frozen=True)
class PDPRuinRepair:
    name = "pdp_ruin_repair"
    num_loc: int = 20  # even; gs = num_loc + 1
    min_loc: float = 0.0
    max_loc: float = 1.0
    history: int = 4   # slots of the removal record (the decoder reads the last 3 and the mean)

    def __post_init__(self):
        assert self.num_loc % 2 == 0

    @property
    def gs(self) -> int:
        return self.num_loc + 1

    def generate(self, batch_size: int, generator=None, device="cuda") -> dict:
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        locs = torch.rand(batch_size, self.num_loc, 2, generator=generator, device=device)
        depot = torch.rand(batch_size, 2, generator=generator, device=device)
        return {"locs": self.min_loc + locs * span, "depot": self.min_loc + depot * span}

    def reset(self, instances: dict, generator=None) -> PDPRRState:
        """A feasible random tour: the pairs in a random order, each pickup
        straight before its delivery."""
        depot = instances["depot"]
        b, half = depot.shape[0], self.gs // 2
        perm = torch.argsort(torch.rand(b, half, generator=generator, device=depot.device),
                             dim=-1) + 1
        seq = torch.stack([perm, perm + half], dim=-1).reshape(b, -1)
        order = torch.cat([torch.zeros_like(seq[:, :1]), seq], dim=1)
        return self.reset_from(instances, scatter_permutation(order, torch.roll(order, -1, -1)))

    def reset_from(self, instances: dict, rec: torch.Tensor) -> PDPRRState:
        """The state whose initial tour is the linked list ``rec [B, N+1]``."""
        locs = torch.cat([instances["depot"][:, None, :], instances["locs"]], dim=1)
        rec = torch.as_tensor(rec, device=locs.device).long()
        cost = linked_list_cost(locs, rec)
        b = rec.shape[0]
        return PDPRRState(
            locs=locs, rec_current=rec, rec_best=rec, cost_current=cost, cost_bsf=cost,
            visited_time=compute_visited_time(rec),
            action_record=torch.zeros(b, self.history, self.gs // 2, device=locs.device),
            i=torch.zeros(b, dtype=torch.long, device=locs.device))

    def step(self, state: PDPRRState, action: torch.Tensor):
        """(next state, reward ``[B]``); ``action [B, 3]`` is (pair, first, second)."""
        action = action.long()
        next_rec = ruin_repair_move(state.rec_current, action[:, 0] + 1, action[:, 1],
                                    action[:, 2])
        record = torch.cat([state.action_record[:, 1:],
                            torch.zeros_like(state.action_record[:, :1])], dim=1)
        record[:, -1].scatter_(1, action[:, :1], 1.0)
        return advance(state, next_rec, count_step=True, action_record=record)

    def step_to_solution(self, state: PDPRRState, rec: torch.Tensor):
        return advance(state, rec, count_step=False)

    def check_solution_validity(self, instance, rec) -> None:
        seen = check_linked_tour(rec, self.gs)
        half = self.gs // 2
        pos = {node: t for t, node in enumerate(seen)}
        for p in range(1, half + 1):
            assert pos[p] < pos[p + half], f"Delivery {p + half} before pickup {p}"
