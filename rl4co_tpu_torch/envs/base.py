"""Environment protocol (counterpart of `rl4co_tpu/envs/base.py`).

An environment is a *frozen config object* exposing pure functions over a
small dataclass of tensors. Where the JAX package writes them per instance
and vmaps, here the batch dimension is written out:

    generate(batch_size, generator, device) -> instances (dict[str, Tensor [B, ...]])
    reset(instances)        -> state
    step(state, action)     -> state        (action [B])
    action_mask(state)      -> bool [B, num_actions]
    reward(state, actions)  -> [B]          (deferred, episode-end)

Conventions every env obeys (they make a fixed-trip-count decode loop work):

- ``state.done: bool [B]`` and ``state.i: int64 [B]`` (steps taken) always exist.
- ``max_steps`` is a static upper bound on episode length.
- Once ``done``, ``step`` is an identity (absorbing) and ``action_mask``
  allows exactly one "padding" action whose log-prob the decode loop zeroes
  and which never changes the reward.
- ``check_solution_validity(instance, actions)`` raises on infeasible
  solutions (host-side, numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional

import torch

Instance = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Env:
    """Base frozen env config. Subclasses add static fields (e.g. ``num_loc``)."""

    name: ClassVar[str] = "base"

    # ---- batched pure functions (override in subclasses) ----

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        raise NotImplementedError

    def reset(self, instances: Instance) -> Any:
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor) -> Any:
        raise NotImplementedError

    def action_mask(self, state: Any) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, state: Any, actions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ---- static shape info ----

    @property
    def num_actions(self) -> int:
        raise NotImplementedError

    @property
    def max_steps(self) -> int:
        """Static upper bound on decode steps (the loop's trip count)."""
        raise NotImplementedError

    # ---- multistart hooks (POMO) ----

    def get_num_starts(self) -> int:
        return self.num_actions

    def select_start_nodes(self, instances: Instance, num_starts: int) -> torch.Tensor:
        """Return ``[B, num_starts]`` forced first actions."""
        locs = next(iter(instances.values()))
        starts = torch.arange(num_starts, dtype=torch.long, device=locs.device)
        return starts[None, :].expand(locs.shape[0], -1)

    # ---- host-side checks ----

    def check_solution_validity(self, instance, actions) -> None:
        raise NotImplementedError
