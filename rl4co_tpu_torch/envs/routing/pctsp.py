"""Prize-Collecting TSP and its stochastic variant (counterpart of
`rl4co_tpu/envs/routing/pctsp.py`).

Collect at least ``prize_required`` of prize, paying a penalty for every
customer left out; reward = saved penalties − tour length − total penalty.
The depot (node 0) is infeasible until the prize is met, unless no customer
is left. The reward closes the tour from the depot over the padded depot
actions.

In the stochastic variant (SPCTSP) the agent embeds the *expected*
(deterministic) prize while the *realised* (stochastic) prize drives the
constraint and the context.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done, sorted_without_repeats
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import get_tour_length

# Kool et al. (2019) penalty scaling
MAX_LENGTHS = {20: 2.0, 50: 3.0, 100: 4.0}


@dataclasses.dataclass
class PCTSPState:
    locs: torch.Tensor               # [B, N+1, 2], depot at 0
    expected_prize: torch.Tensor     # [B, N]
    real_prize: torch.Tensor         # [B, N+1], depot 0
    penalty: torch.Tensor            # [B, N+1], depot 0
    cur_total_prize: torch.Tensor    # f32 [B]
    cur_total_penalty: torch.Tensor  # f32 [B]
    prize_required: torch.Tensor     # f32 [B]
    current_node: torch.Tensor       # int64 [B]
    visited: torch.Tensor            # bool [B, N+1]
    i: torch.Tensor                  # int64 [B], steps taken
    done: torch.Tensor               # bool [B]


@dataclasses.dataclass(frozen=True)
class PCTSP(Env):
    name = "pctsp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    penalty_factor: float = 3.0
    prize_required: float = 1.0
    stochastic: bool = False

    @property
    def _max_penalty(self) -> float:
        base = MAX_LENGTHS.get(
            self.num_loc,
            MAX_LENGTHS[min(MAX_LENGTHS, key=lambda k: abs(k - self.num_loc))],
        )
        return base * self.penalty_factor / self.num_loc

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depot; penalties U(0, max penalty);
        deterministic prizes U(0, 4/N); stochastic prizes U(0, 2) times them.
        Draws come from ``generator`` (its own stream)."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        n = self.num_loc

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        locs = self.min_loc + span * uniform(batch_size, n, 2)
        depot = self.min_loc + span * uniform(batch_size, 2)
        penalty = uniform(batch_size, n) * self._max_penalty
        det_prize = uniform(batch_size, n) * (4.0 / n)
        sto_prize = uniform(batch_size, n) * 2.0 * det_prize
        return {"locs": locs, "depot": depot, "penalty": penalty,
                "deterministic_prize": det_prize, "stochastic_prize": sto_prize}

    def reset(self, instances: Instance) -> PCTSPState:
        locs = torch.cat([instances["depot"][:, None, :], instances["locs"]], dim=1)
        b, dev = locs.shape[0], locs.device
        real = instances["stochastic_prize" if self.stochastic else "deterministic_prize"]
        zero = torch.zeros((b, 1), dtype=locs.dtype, device=dev)
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return PCTSPState(
            locs=locs,
            expected_prize=instances["deterministic_prize"],
            real_prize=torch.cat([zero, real], dim=1),
            penalty=torch.cat([zero, instances["penalty"]], dim=1),
            cur_total_prize=torch.zeros((b,), dtype=torch.float32, device=dev),
            cur_total_penalty=instances["penalty"].sum(dim=-1),
            prize_required=torch.full((b,), self.prize_required, dtype=torch.float32,
                                      device=dev),
            current_node=zeros,
            visited=torch.zeros((b, self.num_loc + 1), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: PCTSPState, action: torch.Tensor) -> PCTSPState:
        action = action.long()
        idx = action[:, None]
        new = dataclasses.replace(
            state,
            cur_total_prize=state.cur_total_prize + torch.gather(state.real_prize, 1, idx)[:, 0],
            cur_total_penalty=state.cur_total_penalty + torch.gather(state.penalty, 1, idx)[:, 0],
            visited=state.visited.scatter(1, idx, True),
            current_node=action,
            i=state.i + 1,
            done=(state.i > 0) & (action == 0),
        )
        return freeze_done(new, state)

    def action_mask(self, state: PCTSPState) -> torch.Tensor:
        infeasible = state.visited | state.visited[:, :1]
        unvisited_left = (~state.visited[:, 1:]).sum(dim=-1) > 0
        infeasible[:, 0] = (state.cur_total_prize < self.prize_required) & unvisited_left
        feasible = ~infeasible
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True                                          # absorbing: depot only
        return torch.where(state.done[:, None], pad, feasible)

    def reward(self, state: PCTSPState, actions: torch.Tensor) -> torch.Tensor:
        idx = actions.long()
        ordered = torch.cat([
            state.locs[:, :1],
            torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2)),
        ], dim=1)
        length = get_tour_length(ordered)
        saved_penalty = torch.gather(state.penalty, 1, idx).sum(dim=-1)
        return saved_penalty - (length + state.penalty[:, 1:].sum(dim=-1))

    @property
    def num_actions(self) -> int:
        return self.num_loc + 1

    @property
    def max_steps(self) -> int:
        return self.num_loc + 2

    def get_num_starts(self) -> int:
        return self.num_loc  # every customer, never the depot

    def select_start_nodes(self, instances: Instance, num_starts: int) -> torch.Tensor:
        """Customers ``1..num_starts``."""
        locs = instances["locs"]
        starts = torch.arange(1, num_starts + 1, dtype=torch.long, device=locs.device)
        return starts[None, :].expand(locs.shape[0], -1)

    def check_solution_validity(self, instance, actions) -> None:
        """No customer twice, and the realised prize collected reaches
        ``prize_required`` (1e-5 of slack) unless every customer was visited.
        Takes one instance (``actions [T]``) or a batch (``[B, T]``)."""
        actions = to_numpy(actions)
        if not sorted_without_repeats(actions):
            raise AssertionError("Duplicates")
        real = to_numpy(instance["stochastic_prize" if self.stochastic
                                 else "deterministic_prize"])
        pad = np.zeros(real.shape[:-1] + (1,), dtype=np.float64)
        prize = np.concatenate([pad, real], axis=-1)
        total = np.take_along_axis(prize, actions, axis=-1).sum(axis=-1)
        visited_all = (actions > 0).sum(axis=-1) == self.num_loc  # no customer repeats
        if not ((total >= self.prize_required - 1e-5) | visited_all).all():
            raise AssertionError(
                f"Total prize {total} below required {self.prize_required}")


@dataclasses.dataclass(frozen=True)
class SPCTSP(PCTSP):
    """Stochastic PCTSP: the realised prize drives the constraint."""

    name = "spctsp"
    stochastic: bool = True
