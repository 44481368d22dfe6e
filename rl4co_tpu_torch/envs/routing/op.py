"""Orienteering Problem environment (counterpart of `rl4co_tpu/envs/routing/op.py`).

Collect as much prize as a tour-length budget allows; the episode ends when
the agent returns to the depot, which is always feasible (at step 0 too: a
depot first ends the tour at step 1, with no prize). Node 0 is the depot;
customers are ``1..num_loc``. ``max_length`` is stored per node, already
reduced by the return distance to the depot and by 1e-6, so a customer is
feasible when the tour can reach it and still get home.

Prize types: ``const`` (1 everywhere), ``unif`` ((1 + U{0..99}) / 100) and
``dist`` ((1 + floor(d / max d * 99)) / 100, d the distance to the depot,
computed in f32 in the JAX package's order: the floor makes it sensitive to
the last bit). Length budgets by size: {20: 2.0, 50: 3.0, 100: 4.0}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.io import to_numpy
from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.utils.device import resolve_device

MAX_LENGTHS = {20: 2.0, 50: 3.0, 100: 4.0}


def default_max_length(num_loc: int) -> float:
    """The table's budget, or that of the nearest tabled size."""
    if num_loc in MAX_LENGTHS:
        return MAX_LENGTHS[num_loc]
    closest = min(MAX_LENGTHS, key=lambda k: abs(k - num_loc))
    return MAX_LENGTHS[closest]


def euclid(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis: `torch.linalg.vector_norm`, which
    rounds as `jnp.linalg.norm` does on the CPU (``sqrt(x·x)`` differs in the
    last bit for about one pair in ten)."""
    return torch.linalg.vector_norm(x, dim=-1)


def gather_locs(locs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [B]`` of ``locs [B, N, 2]`` -> ``[B, 2]``."""
    return torch.gather(locs, 1, idx[:, None, None].expand(-1, 1, 2))[:, 0]


def freeze_done(new, old):
    """Every field of ``new``, except on the rows that ``old`` has done: the
    step of a finished episode is an identity."""
    done = old.done

    def pick(n, o):
        d = done.reshape(done.shape + (1,) * (n.ndim - 1))
        return torch.where(d, o, n)

    return type(new)(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                        for f in dataclasses.fields(new)})


def sorted_without_repeats(actions: np.ndarray) -> bool:
    """No node but the depot (0) appears twice in any row of ``actions [..., T]``."""
    s = np.sort(actions, axis=-1)
    return bool(((s[..., 1:] == 0) | (s[..., 1:] > s[..., :-1])).all())


@dataclasses.dataclass
class OPState:
    locs: torch.Tensor          # [B, N+1, 2], depot at 0
    prize: torch.Tensor         # [B, N+1], depot prize 0
    max_length: torch.Tensor    # [B, N+1], budget on arrival per node (depot-adjusted)
    tour_length: torch.Tensor   # f32 [B]
    current_node: torch.Tensor  # int64 [B]
    visited: torch.Tensor       # bool [B, N+1]
    i: torch.Tensor             # int64 [B], steps taken
    done: torch.Tensor          # bool [B]


@dataclasses.dataclass(frozen=True)
class OP(Env):
    name = "op"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    prize_type: str = "dist"           # const | unif | dist
    max_length: Optional[float] = None  # None: the table's

    @property
    def _max_length(self) -> float:
        return self.max_length if self.max_length is not None else default_max_length(self.num_loc)

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Uniform locations and depot, prizes of ``prize_type``, the budget
        per instance. Draws come from ``generator`` (its own stream, not
        `jax.random`'s numbers)."""
        device = resolve_device(device)
        span = self.max_loc - self.min_loc
        locs = self.min_loc + span * torch.rand(
            (batch_size, self.num_loc, 2), generator=generator, device=device)
        depot = self.min_loc + span * torch.rand(
            (batch_size, 2), generator=generator, device=device)
        if self.prize_type == "const":
            prize = torch.ones((batch_size, self.num_loc), device=device)
        elif self.prize_type == "unif":
            prize = (1.0 + torch.randint(0, 100, (batch_size, self.num_loc),
                                         generator=generator, device=device).float()) / 100.0
        elif self.prize_type == "dist":
            d = euclid(locs - depot[:, None, :])
            prize = (1.0 + torch.floor(d / d.max(dim=-1, keepdim=True).values * 99.0)) / 100.0
        else:
            raise ValueError(f"Invalid prize_type: {self.prize_type}")
        max_length = torch.full((batch_size,), self._max_length, dtype=torch.float32,
                                device=device)
        return {"locs": locs, "depot": depot, "prize": prize, "max_length": max_length}

    def reset(self, instances: Instance) -> OPState:
        depot = instances["depot"]
        locs = torch.cat([depot[:, None, :], instances["locs"]], dim=1)
        b, dev = locs.shape[0], locs.device
        prize = torch.cat([torch.zeros((b, 1), dtype=locs.dtype, device=dev),
                           instances["prize"]], dim=1)
        max_length = (instances["max_length"][:, None]
                      - euclid(depot[:, None, :] - locs) - 1e-6)
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return OPState(
            locs=locs,
            prize=prize,
            max_length=max_length,
            tour_length=torch.zeros((b,), dtype=torch.float32, device=dev),
            current_node=zeros,
            visited=torch.zeros((b, self.num_loc + 1), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: OPState, action: torch.Tensor) -> OPState:
        action = action.long()
        prev = gather_locs(state.locs, state.current_node)
        cur = gather_locs(state.locs, action)
        new = OPState(
            locs=state.locs,
            prize=state.prize,
            max_length=state.max_length,
            tour_length=state.tour_length + euclid(cur - prev),
            current_node=action,
            visited=state.visited.scatter(1, action[:, None], True),
            i=state.i + 1,
            done=(action == 0) & (state.i > 0),
        )
        return freeze_done(new, state)

    def action_mask(self, state: OPState) -> torch.Tensor:
        cur = gather_locs(state.locs, state.current_node)
        exceeds = (state.tour_length[:, None] + euclid(state.locs - cur[:, None, :])
                   > state.max_length)
        feasible = ~(state.visited | state.visited[:, :1] | exceeds)
        feasible[:, 0] = True                                     # the depot, always
        pad = torch.zeros_like(feasible)
        pad[:, 0] = True                                          # absorbing: depot only
        return torch.where(state.done[:, None], pad, feasible)

    def reward(self, state: OPState, actions: torch.Tensor) -> torch.Tensor:
        return torch.gather(state.prize, 1, actions.long()).sum(dim=-1)

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
        """No customer twice, and the closed tour within the budget (1e-4 of
        slack). Takes one instance (``actions [T]``) or a batch (``[B, T]``)."""
        actions = to_numpy(actions)
        if not sorted_without_repeats(actions):
            raise AssertionError("Duplicates")
        depot, locs = to_numpy(instance["depot"]), to_numpy(instance["locs"])
        locs = np.concatenate([depot[..., None, :], locs], axis=-2)
        ordered = np.take_along_axis(locs, actions[..., None], axis=-2)
        diffs = ordered - np.roll(ordered, shift=1, axis=-2)
        length = np.linalg.norm(diffs, axis=-1).sum(axis=-1)
        budget = to_numpy(instance["max_length"])
        if not (length <= budget + 1e-4).all():
            raise AssertionError(f"Max length exceeded: {length} > {budget}")
