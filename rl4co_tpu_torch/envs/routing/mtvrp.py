"""MTVRP, the 16-variant multi-task VRP of MVMoE and RouteFinder (counterpart
of `rl4co_tpu/envs/routing/mtvrp.py`).

Each instance switches four features on or off:
    O  open routes (no return arc to the depot)
    TW time windows and service times
    L  a limit on each route's length
    B  backhauls (pickups, served after the route's linehauls)
A feature that is off takes a neutral value, so one step and one mask serve
all 16 variants in a mixed batch: windows ``[0, INF]`` and no service time,
a length limit of ``INF``, ``open_route`` False, backhaul demand folded into
linehaul demand. ``INF = 1e18`` is f32's stand-in for infinity (a finite
value keeps ``inf * 0`` out of the masks); the init embedding zeroes a
window end above 1e17. ``distance_limit``, ``open_route`` and ``speed`` are
per-instance scalars, ``[B]`` tensors here; ``locs`` holds the depot as
node 0.

Behaviours of the JAX package kept as they are: the mask reads the *current
node's* backhaul demand to decide whether the vehicle carries backhauls;
without B, backhaul demand is folded into linehaul demand; `step`
multiplies the new time, length and loads by ``action != 0`` (a depot visit
zeroes them). Every distance is `torch.linalg.vector_norm` of the
difference, which rounds as `jnp.linalg.norm`, and each sum keeps JAX's
order: the masks compare with ``<`` and ``>``, where one ulp flips a node.
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

INF = 1e18


def get_vehicle_capacity(num_loc: int) -> float:
    """The demand scaler of Liu et al. 2024 and Ye et al. 2024."""
    if num_loc > 1000:
        extra = 1000 // 5 + (num_loc - 1000) // 33.3
    elif num_loc > 20:
        extra = num_loc // 5
    else:
        extra = 0
    return 30.0 + extra


# per preset: the probability that each feature is on
VARIANT_PRESETS = {
    "all": {"O": 0.5, "TW": 0.5, "L": 0.5, "B": 0.5},
    "single_feat": {"O": 0.5, "TW": 0.5, "L": 0.5, "B": 0.5},
    "single_feat_otw": {"O": 0.5, "TW": 0.5, "L": 0.5, "B": 0.5, "OTW": 0.5},
    "cvrp": {"O": 0.0, "TW": 0.0, "L": 0.0, "B": 0.0},
    "ovrp": {"O": 1.0, "TW": 0.0, "L": 0.0, "B": 0.0},
    "vrpb": {"O": 0.0, "TW": 0.0, "L": 0.0, "B": 1.0},
    "vrpl": {"O": 0.0, "TW": 0.0, "L": 1.0, "B": 0.0},
    "vrptw": {"O": 0.0, "TW": 1.0, "L": 0.0, "B": 0.0},
    "ovrptw": {"O": 1.0, "TW": 1.0, "L": 0.0, "B": 0.0},
    "ovrpb": {"O": 1.0, "TW": 0.0, "L": 0.0, "B": 1.0},
    "ovrpl": {"O": 1.0, "TW": 0.0, "L": 1.0, "B": 0.0},
    "vrpbl": {"O": 0.0, "TW": 0.0, "L": 1.0, "B": 1.0},
    "vrpbtw": {"O": 0.0, "TW": 1.0, "L": 0.0, "B": 1.0},
    "vrpltw": {"O": 0.0, "TW": 1.0, "L": 1.0, "B": 0.0},
    "ovrpbl": {"O": 1.0, "TW": 0.0, "L": 1.0, "B": 1.0},
    "ovrpbtw": {"O": 1.0, "TW": 1.0, "L": 0.0, "B": 1.0},
    "ovrpltw": {"O": 1.0, "TW": 1.0, "L": 1.0, "B": 0.0},
    "vrpbltw": {"O": 0.0, "TW": 1.0, "L": 1.0, "B": 1.0},
    "ovrpbltw": {"O": 1.0, "TW": 1.0, "L": 1.0, "B": 1.0},
}


def variant_name(instance: dict) -> np.ndarray:
    """Each instance's variant (``"cvrp"``, ``"ovrptw"``, ...) read from its
    fields: open routes, a finite depot window end, a finite length limit,
    any backhaul demand."""
    o = to_numpy(instance["open_route"]).astype(bool)
    tw = to_numpy(instance["time_windows"])[..., 0, 1] < 1e17
    lim = to_numpy(instance["distance_limit"]) < 1e17
    back = (to_numpy(instance["demand_backhaul"]) > 0).any(axis=-1)
    names = [("o" if a else "") + "vrp" + ("b" if d else "") + ("l" if c else "")
             + ("tw" if b else "") for a, b, c, d in zip(o, tw, lim, back)]
    return np.asarray(["cvrp" if n == "vrp" else n for n in names])


@dataclasses.dataclass
class MTVRPState:
    locs: torch.Tensor                    # [B, N+1, 2], depot at 0
    demand_linehaul: torch.Tensor         # [B, N+1]
    demand_backhaul: torch.Tensor         # [B, N+1]
    time_windows: torch.Tensor            # [B, N+1, 2]
    service_time: torch.Tensor            # [B, N+1]
    distance_limit: torch.Tensor          # f32 [B]
    open_route: torch.Tensor              # bool [B]
    speed: torch.Tensor                   # f32 [B]
    current_node: torch.Tensor            # int64 [B]
    current_time: torch.Tensor            # f32 [B]
    current_route_length: torch.Tensor    # f32 [B]
    used_capacity_linehaul: torch.Tensor  # f32 [B]
    used_capacity_backhaul: torch.Tensor  # f32 [B]
    visited: torch.Tensor                 # bool [B, N+1]
    i: torch.Tensor                       # int64 [B]
    done: torch.Tensor                    # bool [B]


@dataclasses.dataclass(frozen=True)
class MTVRP(Env):
    name = "mtvrp"
    num_loc: int = 20
    min_loc: float = 0.0
    max_loc: float = 1.0
    capacity: Optional[float] = None
    min_demand: int = 1
    max_demand: int = 10
    min_backhaul: int = 1
    max_backhaul: int = 10
    scale_demand: bool = True
    max_time: float = 4.6
    backhaul_ratio: float = 0.2
    distance_limit: float = 3.0
    speed: float = 1.0
    variant_preset: str = "all"
    use_combinations: bool = True

    @property
    def _capacity(self) -> float:
        return self.capacity if self.capacity is not None else get_vehicle_capacity(self.num_loc)

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Every feature drawn for every instance, then the preset's
        variant chosen per instance (`_subsample_variant`). Integer demands
        ``1..9``, a fifth of the customers backhauls; windows of Liu et al.
        2024 (service in [0.15, 0.18), window length in [0.18, 0.2), a start
        that still lets the vehicle return by ``max_time``). Draws come from
        ``generator`` (its own stream, not `jax.random`'s numbers)."""
        device = resolve_device(device)
        b, n = batch_size, self.num_loc

        def uniform(*shape, low=0.0, high=1.0):
            return low + (high - low) * torch.rand(shape, generator=generator, device=device)

        locs = uniform(b, n + 1, 2, low=self.min_loc, high=self.max_loc)
        line = torch.floor(uniform(b, n, low=self.min_demand - 1, high=self.max_demand - 1)) + 1.0
        back = torch.floor(uniform(b, n, low=self.min_backhaul - 1,
                                   high=self.max_backhaul - 1)) + 1.0
        is_linehaul = uniform(b, n) > self.backhaul_ratio
        line, back = line * is_linehaul, back * ~is_linehaul

        lo, mid, hi = 0.15, 0.18, 0.2
        service = lo + (mid - lo) * uniform(b, n)
        tw_len = mid + (hi - mid) * uniform(b, n)
        d0i = euclid(locs[:, 1:] - locs[:, :1])
        h_max = (self.max_time - service - tw_len) / d0i * self.speed - 1.0
        tw_start = (1 + (h_max - 1) * uniform(b, n)) * d0i / self.speed
        zero = torch.zeros((b, 1), device=device)
        time_windows = torch.stack([
            torch.cat([zero, tw_start], dim=1),
            torch.cat([torch.full((b, 1), self.max_time, device=device), tw_start + tw_len], dim=1),
        ], dim=-1)
        demand_linehaul = torch.cat([zero, line], dim=1)
        demand_backhaul = torch.cat([zero, back], dim=1)
        if self.scale_demand:
            demand_linehaul = demand_linehaul / self._capacity
            demand_backhaul = demand_backhaul / self._capacity
        inst = {
            "locs": locs,
            "demand_linehaul": demand_linehaul,
            "demand_backhaul": demand_backhaul,
            "time_windows": time_windows,
            "service_time": torch.cat([zero, service], dim=1),
            "distance_limit": torch.full((b,), self.distance_limit, device=device),
            "open_route": torch.ones((b,), dtype=torch.bool, device=device),
            "speed": torch.full((b,), self.speed, device=device),
        }
        return self._subsample_variant(inst, generator)

    def _subsample_variant(self, inst: Instance,
                           generator: Optional[torch.Generator] = None) -> Instance:
        """Switch the features off per instance by the preset: ``all`` (with
        combinations) keeps each feature with its probability
        independently; ``single_feat`` / ``single_feat_otw`` keep at most one
        (plain CVRP at weight 0.5, OTW switching O and TW on together);
        every other preset is fixed."""
        probs = VARIANT_PRESETS[self.variant_preset]
        dev = inst["locs"].device
        b = inst["locs"].shape[0]
        p4 = torch.tensor([probs["O"], probs["TW"], probs["L"], probs["B"]], device=dev)
        if self.use_combinations and self.variant_preset == "all":
            keep = torch.rand((b, 4), generator=generator, device=dev) >= p4
        elif self.variant_preset in ("single_feat", "single_feat_otw"):
            weights = torch.tensor(list(probs.values()) + [0.5], device=dev)
            idx = torch.multinomial(weights.expand(b, -1), 1, generator=generator)[:, 0]
            keep_all = torch.nn.functional.one_hot(idx, len(weights)).bool()
            keep = keep_all[:, :4].clone()
            if self.variant_preset == "single_feat_otw":
                keep[:, 0] |= keep_all[:, 4]
                keep[:, 1] |= keep_all[:, 4]
        else:
            keep = (p4 > 0).expand(b, -1)
        keep_o, keep_tw, keep_l, keep_b = keep.unbind(dim=-1)

        tw = inst["time_windows"]
        default_tw = torch.stack([torch.zeros_like(tw[..., 0]), torch.full_like(tw[..., 1], INF)],
                                 dim=-1)
        line, back = inst["demand_linehaul"], inst["demand_backhaul"]
        return {
            **inst,
            "open_route": torch.where(keep_o, inst["open_route"], False),
            "time_windows": torch.where(keep_tw[:, None, None], tw, default_tw),
            "service_time": torch.where(keep_tw[:, None], inst["service_time"], 0.0),
            "distance_limit": torch.where(keep_l, inst["distance_limit"], INF),
            "demand_linehaul": torch.where(keep_b[:, None], line, line + back),
            "demand_backhaul": torch.where(keep_b[:, None], back, 0.0),
        }

    def reset(self, instances: Instance) -> MTVRPState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        fzeros = torch.zeros((b,), dtype=torch.float32, device=dev)
        return MTVRPState(
            locs=locs,
            demand_linehaul=instances["demand_linehaul"],
            demand_backhaul=instances["demand_backhaul"],
            time_windows=instances["time_windows"],
            service_time=instances["service_time"],
            distance_limit=instances["distance_limit"],
            open_route=instances["open_route"].bool(),
            speed=instances["speed"],
            current_node=zeros,
            current_time=fzeros,
            current_route_length=fzeros.clone(),
            used_capacity_linehaul=fzeros.clone(),
            used_capacity_backhaul=fzeros.clone(),
            visited=torch.zeros((b, self.num_loc + 1), dtype=torch.bool, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: MTVRPState, action: torch.Tensor) -> MTVRPState:
        action = action.long()
        not_depot = (action != 0).float()

        def at(x):  # x[b, action[b]]
            return torch.gather(x, 1, action[:, None])[:, 0]

        dist = euclid(gather_locs(state.locs, action) - gather_locs(state.locs, state.current_node))
        start = at(state.time_windows[..., 0])
        arrival = torch.maximum(state.current_time + dist / state.speed, start)
        visited = state.visited.scatter(1, action[:, None], True)
        new = dataclasses.replace(
            state,
            current_node=action,
            current_time=not_depot * (arrival + at(state.service_time)),
            current_route_length=not_depot * (state.current_route_length + dist),
            used_capacity_linehaul=not_depot * (state.used_capacity_linehaul
                                                + at(state.demand_linehaul)),
            used_capacity_backhaul=not_depot * (state.used_capacity_backhaul
                                                + at(state.demand_backhaul)),
            visited=visited,
            i=state.i + 1,
            done=visited.all(dim=-1),
        )
        return freeze_done(new, state)

    def action_mask(self, state: MTVRPState) -> torch.Tensor:
        locs = state.locs
        d_ij = euclid(locs - gather_locs(locs, state.current_node)[:, None, :])
        d_j0 = euclid(locs - locs[:, :1])
        early, late = state.time_windows[..., 0], state.time_windows[..., 1]
        speed, closed = state.speed[:, None], (~state.open_route)[:, None]
        arrival = state.current_time[:, None] + d_ij / speed
        can_reach_customer = arrival < late
        can_reach_depot = ((torch.maximum(arrival, early) + state.service_time + d_j0 / speed)
                           * closed) < late[:, :1]
        exceeds_dist = (state.current_route_length[:, None] + d_ij + d_j0 * closed
                        > state.distance_limit[:, None])
        linehauls_missing = ((state.demand_linehaul * ~state.visited).sum(dim=-1) > 0)[:, None]
        carrying_backhaul = (torch.gather(state.demand_backhaul, 1, state.current_node[:, None])
                             > 0)
        exceeds_cap_line = state.demand_linehaul + state.used_capacity_linehaul[:, None] > 1.0
        exceeds_cap_back = state.demand_backhaul + state.used_capacity_backhaul[:, None] > 1.0
        meets_demand = ((linehauls_missing & ~exceeds_cap_line & ~carrying_backhaul
                         & (state.demand_linehaul > 0))
                        | (~exceeds_cap_back & (state.demand_backhaul > 0)))
        can_visit = (can_reach_customer & can_reach_depot & meets_demand & ~exceeds_dist
                     & ~state.visited)
        depot_ok = ~((state.current_node == 0) & can_visit[:, 1:].any(dim=-1))
        can_visit = torch.cat([depot_ok[:, None], can_visit[:, 1:]], dim=-1)
        pad = torch.zeros_like(can_visit)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, can_visit)

    def reward(self, state: MTVRPState, actions: torch.Tensor) -> torch.Tensor:
        """Negative length of the routes; open routes drive no arc back to
        the depot."""
        actions = actions.long()
        go_from = torch.cat([torch.zeros_like(actions[:, :1]), actions], dim=1)
        go_to = torch.roll(go_from, -1, dims=1)

        def locs_at(idx):
            return torch.gather(state.locs, 1, idx[:, :, None].expand(-1, -1, 2))

        dists = euclid(locs_at(go_to) - locs_at(go_from))
        skip = (go_to == 0) & state.open_route[:, None]
        return -(dists * ~skip).sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_loc + 1

    @property
    def max_steps(self) -> int:
        return 2 * self.num_loc

    def get_num_starts(self) -> int:
        return self.num_loc

    def select_start_nodes(self, instances: Instance, num_starts: int) -> torch.Tensor:
        """Customers ``1..num_starts``."""
        locs = instances["locs"]
        starts = torch.arange(1, num_starts + 1, dtype=torch.long, device=locs.device)
        return starts[None, :].expand(locs.shape[0], -1)

    def solve(self, instances: Instance, max_runtime: float = 10.0, **kwargs):
        """Classical baseline: by default the multistart nearest-feasible-
        neighbour construction, or pyvrp / lkh / ortools via ``solver=``
        (`mtvrp_baselines.solve`). Returns ``(actions, costs)``."""
        from rl4co_tpu_torch.envs.routing.mtvrp_baselines import solve

        return solve(instances, max_runtime, env=self, **kwargs)

    def check_solution_validity(self, instance, actions) -> None:
        """Every customer once, then a replay of the route length, time
        windows and both loads (1e-4 / 1e-5 of slack); an open route's
        return arc is neither driven nor timed. One instance (``[T]``) or a
        batch (``[B, T]``)."""
        actions = to_numpy(actions)
        if actions.ndim == 2:
            for row in range(actions.shape[0]):
                self.check_solution_validity({k: v[row] for k, v in instance.items()},
                                             actions[row])
            return
        n = self.num_loc
        s = np.sort(actions)
        if not ((s[-n:] == np.arange(1, n + 1)).all() and (s[:-n] == 0).all()):
            raise AssertionError("Invalid tour")
        locs, tw, st = (to_numpy(instance[k]) for k in ("locs", "time_windows", "service_time"))
        line, back = to_numpy(instance["demand_linehaul"]), to_numpy(instance["demand_backhaul"])
        open_route = bool(to_numpy(instance["open_route"]))
        dlim, speed = float(to_numpy(instance["distance_limit"])), float(to_numpy(instance["speed"]))
        t = length = used_l = used_b = 0.0
        cur = 0
        for a in actions:
            d = 0.0 if (open_route and a == 0) else np.linalg.norm(locs[a] - locs[cur])
            length += d
            if length > dlim + 1e-4:
                raise AssertionError("Route exceeds distance limit")
            t = max(t + d / speed, tw[a, 0])
            if t > tw[a, 1] + 1e-4:
                raise AssertionError("Time window violated")
            t += st[a]
            if a == 0:
                t = length = used_l = used_b = 0.0
            else:
                used_l += line[a]
                used_b += back[a]
                if used_l > 1.0 + 1e-5 or used_b > 1.0 + 1e-5:
                    raise AssertionError("Capacity exceeded")
            cur = a
