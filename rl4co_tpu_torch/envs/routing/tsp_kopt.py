"""TSP k-opt improvement environment, 2-opt for DACT and k-opt for NeuOpt
(counterpart of `rl4co_tpu/envs/routing/tsp_kopt.py`).

A solution is a linked list ``rec[b, i] = j`` (the tour goes i -> j). The
MDP improves a random initial tour; the reward of a step is the decrease of
the best-so-far cost. The moves and the visit order are walks along the
list: each is one Python loop over the N positions acting on ``[B]`` index
tensors (a gather and a scatter per position), never a loop over the
batch. Their integer results equal the JAX package's.

Costs: the edge lengths are summed in the order of XLA's CPU reduction
(`utils.ops.xla_cpu_sum`), so that ``rec_best``, which follows ``reward >
0``, moves where the JAX package's moves; XLA's fused square root is not
correctly rounded in every case, so a cost may still differ in its last bit
(the tests and `chip_smoke.py` prove such departures ties).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import (
    inverse_permutation,
    mark_vector_set,
    scatter_permutation,
    xla_cpu_sum,
)


@dataclasses.dataclass
class TSPkoptState:
    locs: torch.Tensor           # [B, N, 2]
    rec_current: torch.Tensor    # [B, N] linked list (int64)
    rec_best: torch.Tensor       # [B, N]
    cost_current: torch.Tensor   # [B] f32
    cost_bsf: torch.Tensor       # [B] f32
    visited_time: torch.Tensor   # [B, N] position in the tour (node 0 at 0, or N)
    i: torch.Tensor              # [B] steps taken


def linked_list_cost(locs: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """Tour length ``[B]`` of linked lists ``rec [B, N]`` over ``locs [B, N, 2]``."""
    nxt = torch.gather(locs, 1, rec[..., None].expand(-1, -1, 2))
    d = nxt - locs
    return xla_cpu_sum((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).sqrt())


def compute_visited_time(rec: torch.Tensor) -> torch.Tensor:
    """Walk each list from node 0: ``vt[b, node]`` is its 1-based position
    (node 0 ends at N)."""
    b, n = rec.shape
    vt = torch.zeros_like(rec)
    pre = torch.zeros((b, 1), dtype=rec.dtype, device=rec.device)
    for i in range(n):
        cur = torch.gather(rec, 1, pre)
        vt.scatter_(1, cur, i + 1)
        pre = cur
    return vt


def random_linked_tour(batch_size: int, n: int, generator: torch.Generator,
                       device) -> torch.Tensor:
    """Random tours ``[B, N]`` as linked lists, one uniform permutation per row."""
    perm = torch.argsort(torch.rand(batch_size, n, generator=generator, device=device), dim=-1)
    return scatter_permutation(perm, torch.roll(perm, -1, dims=-1))


def two_opt_move(rec: torch.Tensor, first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """2-opt on each list: remove the edges pre(first) -> first and second ->
    post(second), link pre(first) -> second and first -> post(second), and
    reverse the segment between. ``first``, ``second``: ``[B]``."""
    n = rec.shape[-1]
    f, s = first[:, None], second[:, None]
    pre_first = torch.gather(inverse_permutation(rec), 1, f)
    pre_first = torch.where(pre_first != s, pre_first, f)
    new_rec = rec.clone()
    new_rec.scatter_(1, pre_first, s)
    post_second = torch.gather(rec, 1, s)
    post_second = torch.where(post_second != f, post_second, s)
    new_rec.scatter_(1, f, post_second)
    cur = f
    for _ in range(n):
        cur_next = torch.gather(rec, 1, cur)
        moving = cur != s
        new_rec.scatter_(1, cur_next, torch.where(moving, cur, torch.gather(new_rec, 1, cur_next)))
        cur = torch.where(moving, cur_next, cur)
    return new_rec


def k_opt_move(rec: torch.Tensor, action: torch.Tensor, k_max: int) -> torch.Tensor:
    """NeuOpt's k-opt move; ``action [B, 3k]`` packs the selected nodes, the
    left and the right ends of the new edges."""
    n = rec.shape[-1]
    selected = action[:, :k_max]
    left = action[:, k_max:2 * k_max]
    right = action[:, 2 * k_max:]
    right_nodes = torch.gather(rec, 1, selected)
    pre = inverse_permutation(rec)
    new_rec = mark_vector_set(rec, left, right)
    cur = left[:, :1]
    for _ in range(n - 2):
        next_cur = torch.gather(new_rec, 1, cur)
        pre_next = torch.gather(pre, 1, next_cur)
        reverse = (cur != pre_next) & ~(next_cur == right_nodes).any(dim=-1, keepdim=True)
        next_next = torch.gather(new_rec, 1, next_cur)
        new_rec.scatter_(1, next_cur, torch.where(reverse, pre_next, next_next))
        cur = next_cur
    return new_rec


def advance(state, next_rec: torch.Tensor, count_step: bool, **fields):
    """The state after moving to ``next_rec``, and the decrease of the
    best-so-far cost (the reward); ``fields`` replace further fields."""
    new_cost = linked_list_cost(state.locs, next_rec)
    now_bsf = torch.minimum(new_cost, state.cost_bsf)
    reward = state.cost_bsf - now_bsf
    rec_best = torch.where((reward > 0.0)[:, None], next_rec, state.rec_best)
    return dataclasses.replace(
        state, rec_current=next_rec, rec_best=rec_best, cost_current=new_cost,
        cost_bsf=now_bsf, visited_time=compute_visited_time(next_rec),
        i=state.i + (1 if count_step else 0), **fields), reward


def check_linked_tour(rec, gs: int) -> list:
    """Raise unless ``rec`` is one cycle over ``gs`` nodes; returns the visit
    order from node 0."""
    rec = np.asarray(rec)
    assert (np.sort(rec) == np.arange(gs)).all(), "Not a tour"
    seen, cur = [], 0
    for _ in range(gs):
        assert cur not in seen, "Subtour detected"
        seen.append(cur)
        cur = int(rec[cur])
    assert cur == 0 and len(seen) == gs
    return seen


@dataclasses.dataclass(frozen=True)
class TSPkopt:
    """The improvement env's configuration. Unlike a constructive `Env`,
    reset draws the initial solution and every step is rewarded."""

    name = "tsp_kopt"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    k_max: int = 2

    @property
    def two_opt_mode(self) -> bool:
        return self.k_max == 2

    @property
    def num_actions(self) -> int:
        return self.num_loc

    def generate(self, batch_size: int, generator=None, device="cuda") -> dict:
        device = resolve_device(device)
        u = torch.rand(batch_size, self.num_loc, 2, generator=generator, device=device)
        return {"locs": self.min_loc + u * (self.max_loc - self.min_loc)}

    def reset(self, instances: dict, generator=None) -> TSPkoptState:
        locs = instances["locs"]
        return self.reset_from(instances, random_linked_tour(
            locs.shape[0], self.num_loc, generator, locs.device))

    def reset_from(self, instances: dict, rec: torch.Tensor) -> TSPkoptState:
        """The state whose initial tour is the given linked list ``rec [B, N]``."""
        locs = instances["locs"]
        rec = torch.as_tensor(rec, device=locs.device).long()
        cost = linked_list_cost(locs, rec)
        return TSPkoptState(locs=locs, rec_current=rec, rec_best=rec, cost_current=cost,
                            cost_bsf=cost, visited_time=compute_visited_time(rec),
                            i=torch.zeros(rec.shape[0], dtype=torch.long, device=rec.device))

    def step(self, state: TSPkoptState, action: torch.Tensor):
        """(next state, reward ``[B]``)."""
        action = action.long()
        if self.two_opt_mode:
            next_rec = two_opt_move(state.rec_current, action[:, 0], action[:, 1])
        else:
            next_rec = k_opt_move(state.rec_current, action, self.k_max)
        return advance(state, next_rec, count_step=True)

    def step_to_solution(self, state: TSPkoptState, rec: torch.Tensor):
        """Force the current solution to ``rec``."""
        return advance(state, rec, count_step=False)

    def get_best_tour(self, state: TSPkoptState) -> torch.Tensor:
        """The best linked lists as visiting orders ``[B, N]``."""
        vt = compute_visited_time(state.rec_best)
        return torch.argsort(vt % self.num_loc, dim=-1)

    def check_solution_validity(self, instance, rec) -> None:
        check_linked_tour(rec, self.num_loc)
