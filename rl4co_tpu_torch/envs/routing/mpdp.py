"""Multi-agent Pickup and Delivery (mPDP, the Equity-Transformer's problem;
counterpart of `rl4co_tpu/envs/routing/mpdp.py`).

Nodes: ``0..A`` are ``A + 1`` copies of the depot (one coordinate), then
``n/2`` pickups, then their ``n/2`` deliveries. ``agent_idx = count_depot +
1`` starts at 1; when the agent selects depot copy ``agent_idx`` its tour
ends and the next agent starts. A delivery unlocks when its pickup is
visited (``(a + n/2) mod (n + A + 1)``). Objective: ``minmax`` (the longest
agent tour) or ``minsum``.

The JAX module corrects two faults of the reference's dead code, and so
does this one: an episode is done once every customer is visited (the
reference's "every node" never holds, copy 0 being unselectable), and step 0
offers the pickups and copies 1..A only (the reference's offers every node
but copy 0, locked deliveries too). Each agent's return leg is counted when
it selects its copy; the last agent's is added in ``reward``.
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
class MPDPState:
    locs: torch.Tensor          # [B, A+1+N, 2]; rows 0..A the depot
    visited: torch.Tensor       # bool [B, A+1+N]
    to_deliver: torch.Tensor    # bool [B, A+1+N]
    lengths: torch.Tensor       # f32 [B, A], each agent's tour length
    count_depot: torch.Tensor   # int64 [B], agents done (agent_idx = count + 1)
    current_node: torch.Tensor  # int64 [B]
    cur_coord: torch.Tensor     # f32 [B, 2]
    i: torch.Tensor             # int64 [B]
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class MPDP(Env):
    name = "mpdp"
    num_loc: int = 20        # customers (even): num_loc / 2 pickup-delivery pairs
    num_agents: int = 3
    min_loc: float = 0.0
    max_loc: float = 1.0
    objective: str = "minmax"

    def __post_init__(self):
        if self.num_loc % 2:
            raise ValueError(f"mPDP needs an even num_loc, got {self.num_loc}")
        if self.objective not in ("minmax", "minsum"):
            raise ValueError(f"objective must be minmax or minsum, got {self.objective!r}")

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

    def reset(self, instances: Instance) -> MPDPState:
        n, a = self.num_loc, self.num_agents
        depot = instances["depot"]
        b, dev = depot.shape[0], depot.device
        locs = torch.cat([depot[:, None, :].expand(b, a + 1, 2), instances["locs"]], dim=1)
        to_deliver = torch.zeros((b, a + 1 + n), dtype=torch.bool, device=dev)
        to_deliver[:, : a + 1 + n // 2] = True
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return MPDPState(
            locs=locs, visited=torch.zeros_like(to_deliver), to_deliver=to_deliver,
            lengths=torch.zeros((b, a), dtype=torch.float32, device=dev),
            count_depot=zeros, current_node=zeros.clone(), cur_coord=depot.float(),
            i=zeros.clone(), done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: MPDPState, action: torch.Tensor) -> MPDPState:
        n, a = self.num_loc, self.num_agents
        action = action.long()
        agent_idx = state.count_depot + 1
        delivery = (action + n // 2) % (n + a + 1)
        visited = state.visited.scatter(1, action[:, None], True)
        new_coord = gather_by_index(state.locs, action)
        leg = torch.linalg.vector_norm(new_coord - state.cur_coord, dim=-1)
        agent = state.count_depot.clamp(0, a - 1)
        # selecting its own depot copy ends the agent's tour
        at_own_depot = (action == agent_idx) & (agent_idx < a)
        new = dataclasses.replace(
            state,
            visited=visited,
            to_deliver=state.to_deliver.scatter(1, delivery[:, None], True),
            lengths=state.lengths.scatter_add(1, agent[:, None], leg[:, None]),
            count_depot=state.count_depot + at_own_depot.long(),
            current_node=action,
            cur_coord=new_coord,
            i=state.i + 1,
            done=visited[:, a + 1:].all(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: MPDPState) -> torch.Tensor:
        n, a = self.num_loc, self.num_agents
        agent_idx = state.count_depot + 1
        feasible = ~state.visited & state.to_deliver
        feasible[:, : a + 1] = False   # depot copies closed ...
        # ... but the agent's own, once every delivery it unlocked is served
        pending = (state.to_deliver & ~state.visited)[:, a + 1 + n // 2:].any(dim=-1)
        can_handover = ~pending & (agent_idx < a)
        own = agent_idx.clamp(0, a)[:, None]
        feasible = feasible.scatter(1, own, can_handover[:, None] | feasible.gather(1, own))
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True               # absorbing after done
        return torch.where(state.done[:, None], pad, feasible)

    def reward(self, state: MPDPState, actions: torch.Tensor) -> torch.Tensor:
        final_leg = torch.linalg.vector_norm(state.cur_coord - state.locs[:, 0], dim=-1)
        agent = state.count_depot.clamp(0, self.num_agents - 1)
        lengths = state.lengths.scatter_add(1, agent[:, None], final_leg[:, None])
        if self.objective == "minmax":
            return -lengths.max(dim=-1).values
        return -lengths.sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_agents + 1 + self.num_loc

    @property
    def max_steps(self) -> int:
        # every customer and up to A - 1 hand-overs
        return self.num_loc + self.num_agents - 1

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer once, each pickup before its delivery. One
        instance (``[T]``) or a batch (``[B, T]``)."""
        n, a = self.num_loc, self.num_agents
        actions = to_numpy(actions)
        for acts in actions.reshape(-1, actions.shape[-1]):
            cust = acts[acts > a]
            if not (np.sort(cust) == np.arange(a + 1, a + 1 + n)).all():
                raise AssertionError("each customer visited exactly once")
            pos = np.empty(a + 1 + n, dtype=int)
            pos[acts] = np.arange(len(acts))
            for p in range(a + 1, a + 1 + n // 2):
                if pos[p] >= pos[p + n // 2]:
                    raise AssertionError(f"delivery {p + n // 2} before pickup {p}")
