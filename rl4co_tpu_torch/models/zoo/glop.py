"""GLOP (Ye et al. 2024): global partition, local construction (counterpart
of `rl4co_tpu/models/zoo/glop.py`).

A tour is built by cheapest insertion in a random order, then revised: each
round rotates every tour by a random offset, cuts it into segments of
``seg_len`` nodes, re-solves every segment of the batch at once as an open
path with its two end nodes fixed (SHPP), by cheapest insertion and, where
a reviser is given, by the reviser's greedy SHPP rollout, and keeps per
segment the shortest of the candidates and the segment as it was.

The insertion loops are batched tensor loops over the insertion order: at
each step the cost of inserting the next node after each tour node ``i`` is
``|i - c| + |c - j| - |i - j|`` (``j`` the successor of ``i``) over all B x N
positions, ``inf`` off the tour, and the first minimum is taken. The random
orders and offsets enter as tensors; by default they are drawn from the
caller's `torch.Generator`, and a replay hands in another package's draws.
The reviser's rollout goes through the port's `rollout`, its logits clipped
by `decoding.xla_tanh`: on a CUDA tensor every decode step launches the
single-query pointer kernel once, at (segments, N = ``seg_len``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.routing.mtsp import SHPP
from rl4co_tpu_torch.models.policies.constructive import rollout
from rl4co_tpu_torch.utils.ops import gather_by_index, get_tour_length, xla_cpu_sum


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis of 2-D points, one rounded
    operation at a time (a difference, two squares, their sum, its root), so
    that the card gives the CPU's bits."""
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _insert(locs: torch.Tensor, nxt: torch.Tensor, edge: torch.Tensor,
            order: torch.Tensor) -> torch.Tensor:
    """Cheapest insertion of the nodes ``order [B, K]``, in that order, into
    the linked tours ``nxt [B, N]`` (-1: not on the tour), whose arc from
    ``i`` has length ``edge[:, i]``. Updates both in place; returns ``nxt``.
    A new arc's length is the term the step computed for it, the same
    rounded operations on the same operands as a fresh computation."""
    rows = torch.arange(locs.shape[0], device=locs.device)
    for t in range(order.shape[1]):
        c = order[:, t]
        loc_c = gather_by_index(locs, c)[:, None, :]                    # [B, 1, 2]
        to_c = _dist(locs, loc_c)                                       # |i - c|
        from_c = _dist(loc_c, gather_by_index(locs, nxt.clamp(min=0)))  # |c - j|
        cost = torch.where(nxt >= 0, to_c + from_c - edge, torch.inf)
        best = cost.argmin(dim=-1)                                      # the first minimum
        nxt[rows, c] = nxt[rows, best]
        nxt[rows, best] = c
        edge[rows, c] = from_c[rows, best]
        edge[rows, best] = to_c[rows, best]
    return nxt


def _walk(nxt: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The visiting order of the linked tours ``nxt [B, N]`` from ``start [B]``."""
    rows = torch.arange(nxt.shape[0], device=nxt.device)
    out = torch.empty_like(nxt)
    cur = start
    for i in range(nxt.shape[1]):
        out[:, i] = cur
        cur = nxt[rows, cur]
    return out


def random_order(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A uniform random permutation of ``range(shape[-1])`` per row."""
    return torch.rand(shape, generator=generator, device=device).argsort(dim=-1)


def batched_random_insertion(locs: torch.Tensor, order: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Cheapest-insertion tours: ``locs [B, N, 2]`` -> visiting orders
    ``[B, N]`` from ``order[:, 0]``. The nodes are inserted in ``order [B, N]``
    (a permutation per row; by default drawn from ``generator``), each where
    it lengthens the tour least, starting from the 2-cycle of the first two."""
    b, n, _ = locs.shape
    if order is None:
        order = random_order((b, n), generator, locs.device)
    order = order.to(locs.device).long()
    rows = torch.arange(b, device=locs.device)
    first, second = order[:, 0], order[:, 1]
    nxt = torch.full((b, n), -1, dtype=torch.long, device=locs.device)
    nxt[rows, first], nxt[rows, second] = second, first
    edge = torch.zeros((b, n), dtype=locs.dtype, device=locs.device)
    loc_a, loc_b = gather_by_index(locs, first), gather_by_index(locs, second)
    edge[rows, first], edge[rows, second] = _dist(loc_a, loc_b), _dist(loc_b, loc_a)
    return _walk(_insert(locs, nxt, edge, order[:, 2:]), first)


def random_insertion(locs: torch.Tensor, order: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`batched_random_insertion` of one instance: ``locs [N, 2]`` -> ``[N]``."""
    return batched_random_insertion(locs[None], None if order is None else order[None],
                                    generator)[0]


def batched_random_insertion_path(locs: torch.Tensor, order: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Cheapest insertion into an open path with fixed ends 0 and N-1 (the
    SHPP objective: a re-solved segment keeps its junctions to the rest of
    the tour). ``locs [B, N, 2]`` -> orders ``[B, N]`` from 0 to N-1; the
    interior nodes go in ``order [B, N-2]`` (a permutation of 1..N-2 per row;
    by default drawn from ``generator``)."""
    b, n, _ = locs.shape
    if order is None:
        order = random_order((b, n - 2), generator, locs.device) + 1
    order = order.to(locs.device).long()
    nxt = torch.full((b, n), -1, dtype=torch.long, device=locs.device)
    nxt[:, 0] = n - 1                          # N-1's successor: none
    edge = torch.zeros((b, n), dtype=locs.dtype, device=locs.device)
    edge[:, 0] = _dist(locs[:, 0], locs[:, n - 1])
    start = torch.zeros((b,), dtype=torch.long, device=locs.device)
    return _walk(_insert(locs, nxt, edge, order), start)


def random_insertion_path(locs: torch.Tensor, order: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`batched_random_insertion_path` of one instance: ``locs [N, 2]`` -> ``[N]``."""
    return batched_random_insertion_path(locs[None], None if order is None else order[None],
                                         generator)[0]


def segments(locs: torch.Tensor, tours: torch.Tensor, offsets: torch.Tensor, seg_len: int):
    """``tours [B, N]`` rotated by ``offsets [B]`` (the node at ``k`` moves to
    ``k + offset``) and cut into B·N/L segments of ``seg_len``: their nodes
    ``[M, L]`` and coordinates ``[M, L, 2]``."""
    b, n, _ = locs.shape
    pos = (torch.arange(n, device=locs.device)[None, :] - offsets.long()[:, None]) % n
    rolled = torch.gather(tours, 1, pos)
    return (rolled.reshape(-1, seg_len),
            gather_by_index(locs, rolled).reshape(-1, seg_len, 2))


def _segment_lengths(seg_locs: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Internal path length of each segment ``seg_locs [M, L, 2]`` visited in
    ``orders [..., M, L]``; the junction arcs, which no end-preserving
    reorder changes, are left out."""
    pts = torch.gather(seg_locs.expand(*orders.shape, 2), -2,
                       orders[..., None].expand(*orders.shape, 2))
    return xla_cpu_sum(_dist(pts[..., 1:, :], pts[..., :-1, :]))


@dataclasses.dataclass(frozen=True)
class GLOP:
    """TSP revision: rotate, cut into ``seg_len`` segments, re-solve every
    segment as an SHPP and keep per segment the shortest candidate, for
    ``n_rounds`` rounds. ``subsolver_policy``: an SHPP policy of the port
    (AM on SHPP-``seg_len``) whose greedy rollout is a third candidate."""

    seg_len: int = 20
    n_rounds: int = 2
    subsolver_policy: Optional[torch.nn.Module] = None

    def _solve_segments(self, seg_locs: torch.Tensor) -> torch.Tensor:
        """The reviser's orders ``[M, L]`` of the segments ``seg_locs [M, L,
        2]``: each segment scaled into the unit square (one factor for both
        axes, so its best order is kept), as the reviser was trained on
        [0, 1]^2, then one greedy rollout over all of them."""
        lo = seg_locs.amin(dim=1, keepdim=True)
        scale = (seg_locs.amax(dim=1, keepdim=True) - lo).amax(dim=-1, keepdim=True)
        seg_norm = (seg_locs - lo) / scale.clamp(min=1e-9)
        with torch.no_grad():
            out = rollout(self.subsolver_policy, SHPP(num_loc=self.seg_len), {"locs": seg_norm},
                          DecodeSpec(kind="greedy", tanh_clipping=10.0),
                          device=seg_locs.device)
        return out.actions[:, :self.seg_len]

    def revise_round(self, locs: torch.Tensor, tours: torch.Tensor, offsets: torch.Tensor,
                     insertion_orders: torch.Tensor) -> torch.Tensor:
        """One round on ``tours [B, N]``: each rotated by ``offsets [B]`` and
        cut into M = B·N/L `segments`, re-solved by insertion in
        ``insertion_orders [M, L-2]`` (and by the reviser), the shortest
        candidate kept per segment."""
        seg_nodes, seg_locs = segments(locs, tours, offsets, self.seg_len)
        identity = torch.arange(self.seg_len, device=locs.device).expand(seg_nodes.shape)
        cands = [identity, batched_random_insertion_path(seg_locs, insertion_orders)]
        if self.subsolver_policy is not None:
            cands.append(self._solve_segments(seg_locs))
        stacked = torch.stack(cands)                                   # [C, M, L]
        best = _segment_lengths(seg_locs, stacked).argmin(dim=0)       # [M]
        orders = torch.gather(stacked, 0, best[None, :, None].expand(1, *seg_nodes.shape))[0]
        return torch.gather(seg_nodes, 1, orders).reshape(tours.shape)

    def draw(self, batch: int, num_loc: int, generator: Optional[torch.Generator],
             device) -> dict:
        """Every draw of `improve`: ``offsets [R, B]`` in ``[0, N)`` and
        ``insertion_orders [R, M, L-2]``, permutations of 1..L-2."""
        m = batch * num_loc // self.seg_len
        offsets = torch.randint(0, num_loc, (self.n_rounds, batch), generator=generator,
                                device=device)
        orders = random_order((self.n_rounds, m, self.seg_len - 2), generator, device) + 1
        return {"offsets": offsets, "insertion_orders": orders}

    def improve(self, locs: torch.Tensor, tours: torch.Tensor,
                generator: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        """``locs [B, N, 2]``, ``tours [B, N]`` -> (revised tours, their
        lengths). ``draws`` (`draw`'s keys) replays given draws; by default
        they come from ``generator``."""
        b, n, _ = locs.shape
        if n % self.seg_len:
            raise ValueError(f"seg_len {self.seg_len} must divide num_loc {n}")
        if draws is None:
            draws = self.draw(b, n, generator, locs.device)
        tours = tours.to(locs.device).long()
        for r in range(self.n_rounds):
            tours = self.revise_round(locs, tours, draws["offsets"][r].to(locs.device),
                                      draws["insertion_orders"][r].to(locs.device))
        return tours, get_tour_length(gather_by_index(locs, tours))

    def solve(self, locs: torch.Tensor, generator: Optional[torch.Generator] = None,
              draws: Optional[dict] = None):
        """Construct by cheapest insertion (``draws["construction_orders"]
        [B, N]``, or drawn), then `improve`."""
        order = None if draws is None else draws["construction_orders"]
        tours = batched_random_insertion(locs, order, generator)
        return self.improve(locs, tours, generator, draws)


# ---------------------------------------------------------------------------
# The VRP adapter: every route of a CVRP solution re-solved as a sub-TSP
# through the depot, on a static [B, R, L] grid of routes padded with the
# depot (index 0): a padded entry costs nothing, the depot-to-depot arc
# being 0, so insertion parks it for free.
# ---------------------------------------------------------------------------


def vrp_route_cost(locs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Total cost of depot-separated ``actions [B, T]`` (0 = depot), the
    vehicle starting and ending at the depot (row 0 of ``locs``)."""
    coords = gather_by_index(locs, actions.long())
    depot = locs[:, :1]
    path = torch.cat([depot, coords, depot], dim=1)
    return torch.linalg.vector_norm(path[:, 1:] - path[:, :-1], dim=-1).sum(dim=1)


def partition_vrp_actions(actions: torch.Tensor, max_routes: int, max_len: int) -> torch.Tensor:
    """``actions [B, T]`` (0 = depot separator) -> route grid ``[B, R, L]`` of
    node indices, depot-padded: a customer after k depot visits is on route
    k. A customer beyond the grid (route ≥ R or position ≥ L) falls into a
    dump slot rather than onto a real one."""
    b, t = actions.shape
    is_dep = actions == 0
    rid = torch.cumsum(is_dep.long(), dim=1) - is_dep.long()
    idx = torch.arange(t, device=actions.device)[None, :]
    start = torch.cummax(torch.where(is_dep, idx + 1, 0), dim=1).values
    pos = idx - start
    valid = ~is_dep & (rid < max_routes) & (pos < max_len)
    flat = torch.where(valid, rid * max_len + pos, max_routes * max_len)
    grid = torch.zeros((b, max_routes * max_len + 1), dtype=actions.dtype, device=actions.device)
    grid.scatter_(1, flat, torch.where(valid, actions, 0))
    return grid[:, :-1].reshape(b, max_routes, max_len)


def _route_len(sub: torch.Tensor, route_nodes: torch.Tensor) -> torch.Tensor:
    """Length of depot -> nodes -> depot of each route; ``sub [M, L+1, 2]``
    holds the depot at row 0 and route node i at row i+1; ``route_nodes
    [M, L]`` (global indices) only say which entries are padding (0)."""
    coords = torch.where((route_nodes > 0)[..., None], sub[:, 1:], sub[:, :1])
    path = torch.cat([sub[:, :1], coords, sub[:, :1]], dim=1)
    return torch.linalg.vector_norm(path[:, 1:] - path[:, :-1], dim=-1).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class GLOPVRPAdapter:
    """Re-solve every route of a CVRP solution as a sub-TSP and keep per
    route the improvement; reordering within a route keeps its members, so
    every capacity still holds."""

    max_routes: int
    max_route_len: int
    min_node_count: int = 4  # smaller routes are left as they are

    def improve(self, locs: torch.Tensor, actions: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                order: Optional[torch.Tensor] = None):
        """``locs [B, N+1, 2]`` (depot row 0), ``actions [B, T]`` (0 = depot)
        -> (new actions ``[B, max(T, R·(L+1))]``, their cost ``[B]``). The
        routes' insertion orders ``order [B·R, L+1]`` are drawn from
        ``generator`` unless given. Where the grid is too small for the
        solution, that instance keeps its actions."""
        b = locs.shape[0]
        r, l = self.max_routes, self.max_route_len
        actions = actions.long()
        routes = partition_vrp_actions(actions, r, l)                   # [B, R, L]
        flat = routes.reshape(b * r, l)
        coords = gather_by_index(locs, routes.reshape(b, r * l)).reshape(b, r, l, 2)
        depot = locs[:, None, :1, :].expand(b, r, 1, 2)
        sub = torch.cat([depot, coords], dim=2).reshape(b * r, l + 1, 2)
        orders = batched_random_insertion(sub, order, generator)        # cycles [B·R, L+1]
        # each cycle from the depot (local index 0); a cycle's direction is free
        start = (orders == 0).long().argmax(dim=1)
        shift = (torch.arange(l + 1, device=locs.device)[None, :] + start[:, None]) % (l + 1)
        orders = torch.gather(orders, 1, shift)
        new_routes = torch.where(orders[:, 1:] > 0,
                                 torch.gather(flat, 1, (orders[:, 1:] - 1).clamp(0, l - 1)), 0)
        accept = ((_route_len(sub, new_routes) < _route_len(sub, flat))
                  & ((flat > 0).sum(dim=1) >= self.min_node_count))
        chosen = torch.where(accept[:, None], new_routes, flat)
        out = torch.cat([torch.zeros_like(chosen[:, :1]), chosen], dim=1).reshape(b, r * (l + 1))
        # customers in the dump slot: the recomposed solution would lose them
        intact = (routes > 0).sum(dim=(1, 2)) == (actions > 0).sum(dim=1)
        width = max(actions.shape[1], r * (l + 1))
        out = torch.nn.functional.pad(out, (0, width - out.shape[1]))
        orig = torch.nn.functional.pad(actions, (0, width - actions.shape[1]))
        out = torch.where(intact[:, None], out, orig)
        return out, vrp_route_cost(locs, out)
