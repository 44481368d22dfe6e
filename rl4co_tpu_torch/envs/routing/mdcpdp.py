"""Multi-Depot Capacitated Pickup and Delivery (counterpart of
`rl4co_tpu/envs/routing/mdcpdp.py`, the single-agent form of PARCO's
multi-agent env).

Nodes: ``num_agents`` depots, then ``num_loc/2`` pickups, then their
deliveries. Selecting a depot hands the tour to that agent; each agent
carries at most its capacity of picked-up loads at once. ``depot_mode``:
one depot shared by every agent (``single``) or one each (``multi``);
``dist_mode``: ``L1`` or ``L2``. ``reward_mode``: ``minsum`` / ``minmax`` of
the agents' lengths, or ``lateness`` / ``lateness_square``, the lengths'
sum and the deliveries' arrival times (squared) mixed by the instance's
lateness weight. ``problem_mode``: ``open`` (no cost for the return to a
depot) or ``close``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import gather_by_index


@dataclasses.dataclass
class MDCPDPState:
    locs: torch.Tensor             # [B, A+N, 2], depots first
    capacity: torch.Tensor         # int64 [B, A], carry capacities
    lateness_weight: torch.Tensor  # f32 [B]
    current_node: torch.Tensor     # int64 [B]
    current_depot: torch.Tensor    # int64 [B]
    current_carry: torch.Tensor    # int64 [B]
    current_length: torch.Tensor   # f32 [B, A]
    arrivetime: torch.Tensor       # f32 [B, A+N]
    available: torch.Tensor        # bool [B, A+N]
    to_deliver: torch.Tensor       # bool [B, A+N]
    i: torch.Tensor                # int64 [B]
    done: torch.Tensor             # bool [B]


@dataclasses.dataclass(frozen=True)
class MDCPDP(Env):
    name = "mdcpdp"
    num_loc: int = 20          # even: pairs
    num_agents: int = 3
    min_capacity: int = 3
    max_capacity: int = 3
    min_lateness_weight: float = 1.0
    max_lateness_weight: float = 1.0
    depot_mode: str = "multi"       # single | multi
    dist_mode: str = "L2"           # L1 | L2
    reward_mode: str = "lateness"   # lateness | lateness_square | minmax | minsum
    problem_mode: str = "open"      # open | close

    @property
    def total_nodes(self) -> int:
        return self.num_agents + self.num_loc

    def _dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.dist_mode == "L1":
            return (a - b).abs().sum(dim=-1)
        return torch.linalg.vector_norm(a - b, dim=-1)

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depots (one shared in ``single`` mode),
        integer capacities in ``[min_capacity, max_capacity]``, a lateness
        weight uniform in ``[min, max)``; draws from ``generator``."""
        device = resolve_device(device)
        a = self.num_agents

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        locs = rand(batch_size, self.num_loc, 2)
        if self.depot_mode == "single":
            depots = rand(batch_size, 1, 2).expand(batch_size, a, 2).contiguous()
        else:
            depots = rand(batch_size, a, 2)
        capacity = torch.randint(self.min_capacity, self.max_capacity + 1, (batch_size, a),
                                 generator=generator, device=device)
        span = self.max_lateness_weight - self.min_lateness_weight
        weight = self.min_lateness_weight + span * rand(batch_size)
        return {"locs": locs, "depots": depots, "capacity": capacity, "lateness_weight": weight}

    def reset(self, instances: Instance) -> MDCPDPState:
        a, n = self.num_agents, self.num_loc
        locs = torch.cat([instances["depots"], instances["locs"]], dim=1)
        b, dev = locs.shape[0], locs.device
        to_deliver = torch.zeros((b, a + n), dtype=torch.bool, device=dev)
        to_deliver[:, : n // 2 + a] = True
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return MDCPDPState(
            locs=locs,
            capacity=instances["capacity"].long(),
            lateness_weight=instances["lateness_weight"].float(),
            current_node=zeros, current_depot=zeros.clone(), current_carry=zeros.clone(),
            current_length=torch.zeros((b, a), dtype=torch.float32, device=dev),
            arrivetime=torch.zeros((b, a + n), dtype=torch.float32, device=dev),
            available=torch.ones_like(to_deliver), to_deliver=to_deliver,
            i=zeros.clone(), done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: MDCPDPState, action: torch.Tensor) -> MDCPDPState:
        a, n = self.num_agents, self.num_loc
        pd_split = n // 2 + a
        cur = action.long()
        started = (state.i > 0)[:, None]
        available = torch.where(started, state.available.scatter(1, cur[:, None], False),
                                state.available)
        to_deliver = state.to_deliver.scatter(1, ((cur + n // 2) % (n + a))[:, None], True)
        carry = (state.current_carry + ((cur < pd_split) & (cur >= a)).long()
                 - (cur >= pd_split).long())
        current_depot = torch.where(cur < a, cur, state.current_depot)

        step_len = self._dist(gather_by_index(state.locs, state.current_node),
                              gather_by_index(state.locs, cur))
        step_len = torch.where((cur < a) & (state.current_node < a), 0.0, step_len)
        if self.problem_mode == "open":
            step_len = torch.where((cur < a) & (state.current_node >= a), 0.0, step_len)
        current_length = state.current_length.scatter_add(1, current_depot[:, None],
                                                          step_len[:, None])
        arrive = torch.gather(current_length, 1, current_depot[:, None])
        new = dataclasses.replace(
            state,
            current_node=cur,
            current_depot=current_depot,
            current_carry=carry,
            current_length=current_length,
            arrivetime=state.arrivetime.scatter(1, cur[:, None], arrive),
            available=available,
            to_deliver=to_deliver,
            i=state.i + 1,
            done=~available[:, a:].any(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: MDCPDPState) -> torch.Tensor:
        # `back_flag` (just returned to its own depot) switches the mask from
        # touring (customers and the own depot) to handing over (depots left)
        a, n = self.num_agents, self.num_loc
        pd_split = n // 2 + a
        dev = state.available.device
        idx = torch.arange(a + n, device=dev)[None, :]
        cur, i = state.current_node, state.i
        depots_left = state.available[:, :a].any(dim=-1)
        # i - 1 is the reference's step counter at mask time; with no depot
        # left to hand over to, the last agent keeps touring
        back_flag = (cur < a) & (cur == state.current_depot) & (i > 1) & depots_left
        mask = state.available & state.to_deliver
        cap = torch.gather(state.capacity, 1, state.current_depot[:, None])[:, 0]
        over_capacity = (state.current_carry >= cap)[:, None]
        is_pickup = (idx >= a) & (idx < pd_split)
        mask = mask & ~(is_pickup & over_capacity)
        mask = torch.where((idx >= a) & back_flag[:, None], False, mask)
        # depots: on a hand-over the depots left; while touring the own depot
        # alone, never while carrying, after the last hand-over, or right
        # after arriving at a new depot
        depot_mask = mask & back_flag[:, None]
        depot_mask = depot_mask.scatter(1, state.current_depot[:, None], ~back_flag[:, None])
        prev_depot = (cur < a) & (i > 1) & ~back_flag
        closed = ~depots_left | (state.current_carry > 0) | prev_depot
        depot_mask = depot_mask & ~closed[:, None]
        mask = torch.where(idx < a, depot_mask, mask)
        first = (idx < a).expand_as(mask)
        mask = torch.where((i == 0)[:, None], first, mask)
        pad = torch.zeros_like(mask).scatter(1, state.current_depot[:, None], True)
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: MDCPDPState, actions: torch.Tensor) -> torch.Tensor:
        a, n = self.num_agents, self.num_loc
        if self.reward_mode == "minmax":
            cost = state.current_length.max(dim=-1).values
        elif self.reward_mode == "minsum":
            cost = state.current_length.sum(dim=-1)
        else:
            cost = state.current_length.sum(dim=-1)
            lateness = state.arrivetime[:, a + n // 2:]
            if self.reward_mode == "lateness_square":
                lateness = lateness ** 2
            w = state.lateness_weight
            cost = cost * (1 - w) + lateness.sum(dim=-1) * w
        return -cost

    @property
    def num_actions(self) -> int:
        return self.total_nodes

    @property
    def max_steps(self) -> int:
        # one depot choice, N visits, up to N/2 depot returns, and a pad
        return 1 + self.num_loc + self.num_loc // 2 + self.num_agents

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer once, each pickup before its delivery. One
        instance (``[T]``) or a batch (``[B, T]``)."""
        a, n = self.num_agents, self.num_loc
        actions = to_numpy(actions)
        for acts in actions.reshape(-1, actions.shape[-1]):
            if sorted(acts[acts >= a].tolist()) != list(range(a, a + n)):
                raise AssertionError("Each customer must be visited exactly once")
            pos = {int(node): t for t, node in enumerate(acts)}
            for p in range(a, a + n // 2):
                if pos[p] >= pos[p + n // 2]:
                    raise AssertionError("Delivery before pickup")
