"""Multiple TSP and the Shortest Hamiltonian Path Problem (counterpart of
`rl4co_tpu/envs/routing/mtsp.py`).

MTSP: ``num_agents`` salesmen (per instance) each tour from and to the depot,
node 0 of ``locs``; a depot visit hands over to the next agent, and the last
agent must finish. The cost is the longest subtour (``minmax``, default) or
the total length (``sum``).

SHPP: a path from node 0 to node N-1 through every node (GLOP's
sub-problem); the mask forces node 0 first and keeps N-1 for last, and the
reward is the closed tour's length (the closing arc stands for GLOP's
virtual connection).

Neither overrides the multistart hooks: their starts are the base class's
``0..num_actions-1``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import euclid, freeze_done, gather_locs
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import get_tour_length


def one_hot_rows(like: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bool ``[B, N]`` shaped as ``like`` with column ``idx [B]`` set."""
    return torch.zeros_like(like, dtype=torch.bool).scatter(1, idx[:, None], True)


@dataclasses.dataclass
class MTSPState:
    locs: torch.Tensor                # [B, N, 2], depot at 0
    num_agents: torch.Tensor          # int64 [B]
    agent_idx: torch.Tensor           # int64 [B]
    current_length: torch.Tensor      # f32 [B], the current agent's tour so far
    max_subtour_length: torch.Tensor  # f32 [B]
    first_node: torch.Tensor          # int64 [B]
    current_node: torch.Tensor        # int64 [B]
    available: torch.Tensor           # bool [B, N], selectable next
    i: torch.Tensor                   # int64 [B]
    done: torch.Tensor                # bool [B]


@dataclasses.dataclass(frozen=True)
class MTSP(Env):
    name = "mtsp"
    num_loc: int = 20  # the depot included
    min_loc: float = 0.0
    max_loc: float = 1.0
    min_num_agents: int = 5
    max_num_agents: int = 5
    cost_type: str = "minmax"  # minmax | sum

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations (node 0 the depot) and a number of agents
        uniform in ``[min_num_agents, max_num_agents]``, from ``generator``."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        locs = self.min_loc + span * torch.rand(
            (batch_size, self.num_loc, 2), generator=generator, device=device)
        num_agents = torch.randint(self.min_num_agents, self.max_num_agents + 1, (batch_size,),
                                   generator=generator, device=device)
        return {"locs": locs, "num_agents": num_agents}

    def reset(self, instances: Instance) -> MTSPState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        available = torch.ones((b, self.num_loc), dtype=torch.bool, device=dev)
        available[:, 0] = False
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        fzeros = torch.zeros((b,), dtype=torch.float32, device=dev)
        return MTSPState(
            locs=locs, num_agents=instances["num_agents"].long(), agent_idx=zeros,
            current_length=fzeros, max_subtour_length=fzeros.clone(),
            first_node=zeros.clone(), current_node=zeros.clone(), available=available,
            i=zeros.clone(), done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: MTSPState, action: torch.Tensor) -> MTSPState:
        action = action.long()
        cur_loc = gather_locs(state.locs, action)
        agent_idx = state.agent_idx + (action == 0).long()
        available = state.available.scatter(1, action[:, None], False)
        done = (~available[:, 1:]).all(dim=-1)
        length = state.current_length + euclid(cur_loc - gather_locs(state.locs, state.current_node))
        length = torch.where(done, length + euclid(cur_loc - state.locs[:, 0]), length)
        new = dataclasses.replace(
            state,
            first_node=torch.where(state.i == 0, action, state.first_node),
            current_node=action,
            agent_idx=agent_idx,
            available=available,
            # a handover closes the agent's tour: the next one starts at 0
            current_length=length * (agent_idx == state.agent_idx),
            max_subtour_length=torch.maximum(state.max_subtour_length, length),
            i=state.i + 1,
            done=done,
        )
        return freeze_done(new, state)

    def action_mask(self, state: MTSPState) -> torch.Tensor:
        # the depot: not from the depot, and only while another agent is left
        depot_ok = (state.current_node != 0) & (state.agent_idx < state.num_agents - 1)
        mask = torch.cat([depot_ok[:, None], state.available[:, 1:]], dim=-1)
        pad = one_hot_rows(mask, torch.zeros_like(state.current_node))
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: MTSPState, actions: torch.Tensor) -> torch.Tensor:
        if self.cost_type == "minmax":
            return -state.max_subtour_length
        if self.cost_type == "sum":
            idx = actions.long()
            return -get_tour_length(torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2)))
        raise ValueError(f"Cost type {self.cost_type} not supported")

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        # N-1 customers, up to max_num_agents-1 handovers, and a pad
        return self.num_loc + self.max_num_agents

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer exactly once. One instance (``[T]``) or a batch."""
        actions = to_numpy(actions)
        for row in actions.reshape(-1, actions.shape[-1]):
            customers = np.sort(row[row > 0])
            if len(customers) != self.num_loc - 1 or (customers != np.arange(1, self.num_loc)).any():
                raise AssertionError("Each customer must be visited exactly once")


@dataclasses.dataclass
class SHPPState:
    locs: torch.Tensor          # [B, N, 2]
    first_node: torch.Tensor    # int64 [B], 0
    last_node: torch.Tensor     # int64 [B], N-1
    current_node: torch.Tensor  # int64 [B]
    available: torch.Tensor     # bool [B, N]
    i: torch.Tensor             # int64 [B]
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class SHPP(Env):
    name = "shpp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        return {"locs": self.min_loc + span * torch.rand(
            (batch_size, self.num_loc, 2), generator=generator, device=device)}

    def reset(self, instances: Instance) -> SHPPState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return SHPPState(
            locs=locs, first_node=zeros, last_node=torch.full_like(zeros, self.num_loc - 1),
            current_node=zeros.clone(),
            available=torch.ones((b, self.num_loc), dtype=torch.bool, device=dev),
            i=zeros.clone(), done=torch.zeros((b,), dtype=torch.bool, device=dev))

    def step(self, state: SHPPState, action: torch.Tensor) -> SHPPState:
        action = action.long()
        available = state.available.scatter(1, action[:, None], False)
        new = dataclasses.replace(state, current_node=action, available=available,
                                  i=state.i + 1, done=~available.any(dim=-1))
        return freeze_done(new, state)

    def action_mask(self, state: SHPPState) -> torch.Tensor:
        # node 0 first; the last node only once nothing else is left
        others_left = state.available[:, :-1].any(dim=-1)
        mask = torch.cat([state.available[:, :-1],
                          (state.available[:, -1] & ~others_left)[:, None]], dim=-1)
        first_only = one_hot_rows(mask, torch.zeros_like(state.current_node))
        mask = torch.where((state.i == 0)[:, None], first_only, mask)
        pad = one_hot_rows(mask, state.current_node)
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: SHPPState, actions: torch.Tensor) -> torch.Tensor:
        idx = actions[:, : self.num_loc].long()
        return -get_tour_length(torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2)))

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        return self.num_loc

    def check_solution_validity(self, instance, actions) -> None:
        """A permutation from node 0 to node N-1. One instance or a batch."""
        actions = to_numpy(actions)[..., : self.num_loc]
        if not (np.sort(actions, axis=-1) == np.arange(self.num_loc)).all():
            raise AssertionError("Invalid tour")
        if not ((actions[..., 0] == 0) & (actions[..., -1] == self.num_loc - 1)).all():
            raise AssertionError("SHPP must start at node 0 and end at node N-1")
