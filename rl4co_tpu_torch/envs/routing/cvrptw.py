"""CVRP with Time Windows (counterpart of `rl4co_tpu/envs/routing/cvrptw.py`).

CVRP plus integer time windows within ``[0, max_time]`` that leave every
customer's return to the depot feasible; service durations are zero (as the
reference generator's). The reward stays the negative tour length: the
windows are constraints only. With the defaults (``max_loc`` 150,
``max_time`` 480, ``scale=False``) coordinates and times enter the network
unscaled.

A move's new time is ``max(t + d, window start) + duration`` (0 back at the
depot); a node is feasible only if ``t + d <= window end``, the depot too.
Distances are `torch.linalg.vector_norm` of the difference, which rounds as
`jnp.linalg.norm`: one ulp flips a node's feasibility at ``<=``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Instance
from rl4co_tpu_torch.envs.routing.cvrp import CVRP
from rl4co_tpu_torch.envs.routing.op import euclid, freeze_done, gather_locs


@dataclasses.dataclass
class CVRPTWState:
    locs: torch.Tensor           # [B, N+1, 2], depot at 0
    demand: torch.Tensor         # [B, N]
    time_windows: torch.Tensor   # [B, N+1, 2]
    durations: torch.Tensor      # [B, N+1]
    current_time: torch.Tensor   # f32 [B]
    used_capacity: torch.Tensor  # f32 [B]
    current_node: torch.Tensor   # int64 [B]
    visited: torch.Tensor        # bool [B, N+1]
    i: torch.Tensor              # int64 [B]
    done: torch.Tensor           # bool [B]


@dataclasses.dataclass(frozen=True)
class CVRPTW(CVRP):
    name = "cvrptw"
    max_loc: float = 150.0
    max_time: float = 480.0
    scale: bool = False

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """CVRP's instances on ``[min_loc, max_loc)``, then per node two
        uniform draws between its distance from the depot and the latest
        start that still returns in time, floored and ordered; the depot's
        window is ``[0, max_time]`` and equal bounds are widened by one."""
        base = super().generate(batch_size, generator, device)
        locs, depot = base["locs"], base["depot"]
        dev = locs.device
        zero = torch.zeros((batch_size, 1), device=dev)
        durations = torch.zeros((batch_size, self.num_loc + 1), device=dev)
        dist = torch.cat([zero, euclid(locs - depot[:, None, :])], dim=1)
        upper = self.max_time - dist - durations
        ts1 = torch.rand(dist.shape, generator=generator, device=dev)
        ts2 = torch.rand(dist.shape, generator=generator, device=dev)
        min_ts = torch.floor(dist + (upper - dist) * ts1)
        max_ts = torch.floor(dist + (upper - dist) * ts2)
        min_t, max_t = torch.minimum(min_ts, max_ts), torch.maximum(min_ts, max_ts)
        min_t[:, 0], max_t[:, 0] = 0.0, self.max_time
        eq = min_t == max_t
        min_t = torch.where(eq, torch.maximum(torch.floor(dist), min_t - 1), min_t)
        eq = min_t == max_t
        max_t = torch.where(eq, torch.minimum(torch.floor(upper), max_t + 1), max_t)
        tw = torch.stack([min_t, max_t], dim=-1)
        if self.scale:
            base["locs"], base["depot"] = locs / self.max_time, depot / self.max_time
            durations, tw = durations / self.max_time, tw / self.max_time
        return {**base, "durations": durations, "time_windows": tw}

    def reset(self, instances: Instance) -> CVRPTWState:
        base = super().reset(instances)
        return CVRPTWState(
            locs=base.locs, demand=base.demand,
            time_windows=instances["time_windows"], durations=instances["durations"],
            current_time=torch.zeros_like(base.used_capacity),
            used_capacity=base.used_capacity, current_node=base.current_node,
            visited=base.visited, i=base.i, done=base.done,
        )

    def step(self, state: CVRPTWState, action: torch.Tensor) -> CVRPTWState:
        action = action.long()
        is_depot = action == 0
        dist = euclid(gather_locs(state.locs, action) - gather_locs(state.locs, state.current_node))
        start = torch.gather(state.time_windows[..., 0], 1, action[:, None])[:, 0]
        duration = torch.gather(state.durations, 1, action[:, None])[:, 0]
        current_time = torch.where(
            is_depot, 0.0, torch.maximum(state.current_time + dist, start) + duration)
        customer = (action - 1).clamp(0, self.num_loc - 1)
        selected = torch.gather(state.demand, 1, customer[:, None])[:, 0]
        visited = state.visited.scatter(1, action[:, None], True)
        new = dataclasses.replace(
            state,
            current_time=current_time,
            used_capacity=torch.where(is_depot, 0.0, state.used_capacity + selected),
            current_node=action,
            visited=visited,
            i=state.i + 1,
            done=visited.all(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: CVRPTWState) -> torch.Tensor:
        # CVRP's rules, then every node reachable before its window closes
        # (`action_mask` of CVRP reads only the fields CVRPTW shares)
        feasible = super().action_mask(state)
        cur = gather_locs(state.locs, state.current_node)
        dist = euclid(state.locs - cur[:, None, :])
        can_reach = state.current_time[:, None] + dist <= state.time_windows[..., 1]
        return torch.where(state.done[:, None], feasible, feasible & can_reach)

    def check_solution_validity(self, instance, actions) -> None:
        """CVRP's rules, then a replay of the time windows (1e-4 of slack):
        service cannot start after a window's end. One instance (``[T]``)
        or a batch (``[B, T]``)."""
        actions = to_numpy(actions)
        if actions.ndim == 2:
            for row in range(actions.shape[0]):
                self.check_solution_validity({k: v[row] for k, v in instance.items()},
                                             actions[row])
            return
        super().check_solution_validity(instance, actions)
        locs = np.concatenate([to_numpy(instance["depot"])[None, :],
                               to_numpy(instance["locs"])])
        tw, dur = to_numpy(instance["time_windows"]), to_numpy(instance["durations"])
        t, cur = 0.0, 0
        for a in actions:
            t = max(t + np.linalg.norm(locs[a] - locs[cur]), tw[a, 0])
            if t > tw[a, 1] + 1e-4:
                raise AssertionError("vehicle cannot start service before deadline")
            t += dur[a]
            cur = a
            if a == 0:
                t = 0.0
