"""Initial (node-feature → embedding) modules per environment (counterpart
of `rl4co_tpu/models/nn/env_embeddings/init.py`). Each module maps a batched
instance dict to node embeddings ``[B, N_actions, D]``. Every embedding
but TSP's, FLP's and MCP's takes ``use_bias`` (default True), as the JAX
modules do: False builds its layers without biases, and its tree has no bias
leaves.
"""

from __future__ import annotations

import torch
from torch import nn

from rl4co_tpu_torch.envs.eda.dpp import grid_locs
from rl4co_tpu_torch.utils.ops import xla_cpu_sum


class TSPInitEmbedding(nn.Module):
    """xy coords → embedding."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed = nn.Linear(2, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        return self.init_embed(instance["locs"])


class VRPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + demand) embedded by two layers; the
    depot is row 0, as in the env's action indexing."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(3, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["demand"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class OPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + prize)."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(3, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["prize"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class PCTSPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + expected prize + penalty): SPCTSP too
    embeds the expected (deterministic) prize, not the realised one."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(4, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["deterministic_prize"][..., None],
                           instance["penalty"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class VRPTWInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy, demand, window start and end, service
    duration): CVRPTW's times enter unscaled, up to its ``max_time``."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(6, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["demand"][..., None],
                           instance["time_windows"][:, 1:, :],
                           instance["durations"][:, 1:, None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class PDPInitEmbedding(nn.Module):
    """Depot (xy); each pickup with its delivery's coordinates (4 features);
    each delivery alone. Rows: depot, pickups, deliveries."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed_pick = nn.Linear(4, embed_dim, bias=use_bias)
        self.init_embed_delivery = nn.Linear(2, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        locs = instance["locs"]
        half = locs.shape[-2] // 2
        pick = torch.cat([locs[:, :half], locs[:, half:]], dim=-1)
        return torch.cat([self.init_embed_depot(instance["depot"][:, None, :]),
                          self.init_embed_pick(pick),
                          self.init_embed_delivery(locs[:, half:])], dim=-2)


class MTSPInitEmbedding(nn.Module):
    """The depot (node 0 of ``locs``) and the cities embedded by two layers."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(2, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        locs = instance["locs"]
        return torch.cat([self.init_embed_depot(locs[:, :1]),
                          self.init_embed(locs[:, 1:])], dim=-2)


class MTVRPInitEmbedding(nn.Module):
    """The depot (node 0 of ``locs``, xy); customers (xy, linehaul and
    backhaul demand, window start and end, service time). A window bound
    above 1e17 (MTVRP's stand-in for infinity: TW off) enters as 0."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(7, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        locs = instance["locs"]
        tw = instance["time_windows"][:, 1:, :]
        tw = torch.where(tw > 1e17, 0.0, tw)
        feats = torch.cat([locs[:, 1:], instance["demand_linehaul"][:, 1:, None],
                           instance["demand_backhaul"][:, 1:, None], tw,
                           instance["service_time"][:, 1:, None]], dim=-1)
        return torch.cat([self.init_embed_depot(locs[:, :1]), self.init_embed(feats)], dim=-2)


class SVRPInitEmbedding(nn.Module):
    """Depot (xy) and customers (xy + required skill)."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed = nn.Linear(3, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        feats = torch.cat([instance["locs"], instance["skills"][..., None]], dim=-1)
        return torch.cat([depot, self.init_embed(feats)], dim=-2)              # [B, N+1, D]


class MPDPInitEmbedding(nn.Module):
    """mPDP: ``num_agents + 1`` copies of the depot, each its embedding plus
    a learned offset of its own (``depot_copy_offset [A+1, D]``, so that the
    agents' hand-over targets differ although their coordinates are equal);
    pickups with their delivery's coordinates; deliveries alone."""

    def __init__(self, embed_dim: int, num_agents: int = 3, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.depot_copy_offset = nn.Parameter(0.02 * torch.randn(num_agents + 1, embed_dim))
        self.init_embed_pick = nn.Linear(4, embed_dim, bias=use_bias)
        self.init_embed_delivery = nn.Linear(2, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        locs = instance["locs"]
        half = locs.shape[-2] // 2
        depot = self.init_embed_depot(instance["depot"][:, None, :])           # [B, 1, D]
        depot = depot + self.depot_copy_offset[None].to(depot.dtype)           # [B, A+1, D]
        pick = torch.cat([locs[:, :half], locs[:, half:]], dim=-1)
        return torch.cat([depot, self.init_embed_pick(pick),
                          self.init_embed_delivery(locs[:, half:])], dim=-2)


class MDCPDPInitEmbedding(nn.Module):
    """The depots (one per agent); pickups with their delivery's
    coordinates; deliveries alone."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed_depot = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed_pick = nn.Linear(4, embed_dim, bias=use_bias)
        self.init_embed_delivery = nn.Linear(2, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        locs = instance["locs"]
        half = locs.shape[-2] // 2
        pick = torch.cat([locs[:, :half], locs[:, half:]], dim=-1)
        return torch.cat([self.init_embed_depot(instance["depots"]),
                          self.init_embed_pick(pick),
                          self.init_embed_delivery(locs[:, half:])], dim=-2)


class DPPInitEmbedding(nn.Module):
    """Grid-cell coordinates (half the width) and each cell's distance from
    the probe (the other half)."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        half = embed_dim // 2
        self.init_embed = nn.Linear(2, half, bias=use_bias)
        self.init_embed_probe = nn.Linear(1, embed_dim - half, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        keepout = instance["keepout"]
        b, n = keepout.shape
        locs = grid_locs(int(n ** 0.5), keepout.device)
        probe_loc = locs[instance["probe"].long()]                             # [B, 2]
        dist = torch.linalg.vector_norm(locs[None] - probe_loc[:, None, :], dim=-1)
        return torch.cat([self.init_embed(locs.expand(b, -1, -1)),
                          self.init_embed_probe(dist[..., None])], dim=-1)


class MDPPInitEmbedding(nn.Module):
    """Grid-cell coordinates and each cell's distance from the nearest
    probe, each embedded at full width, then projected (``project_out``)."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed = nn.Linear(2, embed_dim, bias=use_bias)
        self.init_embed_probe_distance = nn.Linear(1, embed_dim, bias=use_bias)
        self.project_out = nn.Linear(2 * embed_dim, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        probe_mask = instance["probe_mask"]
        b, n = probe_mask.shape
        locs = grid_locs(int(n ** 0.5), probe_mask.device)
        dist = torch.linalg.vector_norm(locs[:, None] - locs[None], dim=-1)   # [N, N]
        min_dist = torch.where(probe_mask[:, None, :], dist[None], torch.inf).amin(dim=-1)
        return self.project_out(torch.cat([self.init_embed(locs.expand(b, -1, -1)),
                                           self.init_embed_probe_distance(min_dist[..., None])],
                                          dim=-1))


class SMTWTPInitEmbedding(nn.Module):
    """(due time, weight, process time) of each job."""

    def __init__(self, embed_dim: int, use_bias: bool = True):
        super().__init__()
        self.init_embed = nn.Linear(3, embed_dim, bias=use_bias)

    def forward(self, instance) -> torch.Tensor:
        return self.init_embed(torch.stack([instance["job_due_time"], instance["job_weight"],
                                            instance["job_process_time"]], dim=-1))


class FLPInitEmbedding(nn.Module):
    """xy coordinates through a biased ``projection``."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.projection = nn.Linear(2, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        return self.projection(instance["locs"])


class MCPInitEmbedding(nn.Module):
    """Each set: the sum of its members' weight embeddings
    (``projection_items``), padded members contributing zero.

    The sets' embeddings reach the hundreds (integer weights up to 9, 15
    members), where the encoder's attention turns an ulp into 1e-4 of a
    logit, so they are computed with the JAX package's bits: the one-input
    projection as a product, then the bias (two roundings, as XLA computes
    it on the CPU; a matrix product fuses them), and the members summed in
    order (`utils.ops.xla_cpu_sum`). The encoder's own products still round
    otherwise, and MCP's greedy tours depart from the JAX package's as they
    depart from themselves in another batch order."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.projection_items = nn.Linear(1, embed_dim)

    def forward(self, instance) -> torch.Tensor:
        weights, membership = instance["weights"], instance["membership"].long()
        lin = self.projection_items
        item_emb = weights[..., None] * lin.weight[:, 0] + lin.bias           # [B, I, D]
        b, s, m = membership.shape
        idx = (membership - 1).clamp(0, weights.shape[-1] - 1).reshape(b, s * m)
        gathered = torch.gather(item_emb, 1, idx[..., None].expand(-1, -1, item_emb.shape[-1]))
        gathered = gathered.reshape(b, s, m, -1) * (membership > 0)[..., None]
        return xla_cpu_sum(gathered.transpose(-1, -2))                        # [B, S, D]


class MatNetInitEmbedding(nn.Module):
    """MatNet's initial row and column embeddings: rows start at zero;
    column j of an instance gets a one-hot in a random slot, distinct per
    column (``"RandomOneHot"``), or uniform noise (``"Random"``). Returns
    ``(row_emb [B, R, D], col_emb [B, C, D], cost_matrix [B, R, C])``. No
    parameters. The JAX package draws the slots from `jax.random`; here
    they come from ``generator`` (its own stream) or are given as ``slots
    [B, C]`` (``noise [B, C, D]`` for ``"Random"``), as a test passes JAX's
    in. The MatNet policy seeds its columns deterministically instead
    (`models/zoo/matnet.py`), as the JAX package's does."""

    def __init__(self, embed_dim: int, mode: str = "RandomOneHot"):
        super().__init__()
        if mode not in ("RandomOneHot", "Random"):
            raise ValueError(f"mode must be 'RandomOneHot' or 'Random', got {mode!r}")
        self.embed_dim = embed_dim
        self.mode = mode

    def forward(self, instance, generator=None, slots=None, noise=None):
        dmat = instance["cost_matrix"]
        b, r, c = dmat.shape
        d, dev = self.embed_dim, dmat.device
        row_emb = torch.zeros((b, r, d), dtype=dmat.dtype, device=dev)
        if self.mode == "Random":
            if noise is None:
                noise = torch.rand((b, c, d), generator=generator, device=dev, dtype=dmat.dtype)
            return row_emb, noise, dmat
        if c > d:
            raise ValueError(f"RandomOneHot needs embed_dim >= num columns ({c})")
        if slots is None:
            keys = torch.rand((b, d), generator=generator, device=dev)
            slots = torch.argsort(keys, dim=-1)[:, :c]
        col_emb = torch.nn.functional.one_hot(slots.long().to(dev), d).to(dmat.dtype)
        return row_emb, col_emb, dmat


INIT_EMBEDDING_REGISTRY = {
    "tsp": TSPInitEmbedding,
    "shpp": TSPInitEmbedding,
    "cvrp": VRPInitEmbedding,
    "cvrpmvc": VRPInitEmbedding,
    "sdvrp": VRPInitEmbedding,
    "svrp": SVRPInitEmbedding,
    "mpdp": MPDPInitEmbedding,
    "mdcpdp": MDCPDPInitEmbedding,
    "cvrptw": VRPTWInitEmbedding,
    "pdp": PDPInitEmbedding,
    "mtsp": MTSPInitEmbedding,
    "mtvrp": MTVRPInitEmbedding,
    "op": OPInitEmbedding,
    "pctsp": PCTSPInitEmbedding,
    "spctsp": PCTSPInitEmbedding,
    "smtwtp": SMTWTPInitEmbedding,
    "dpp": DPPInitEmbedding,
    "mdpp": MDPPInitEmbedding,
    "flp": FLPInitEmbedding,
    "mcp": MCPInitEmbedding,
    "atsp": MatNetInitEmbedding,
}


def env_init_embedding(env_name: str, embed_dim: int, **kwargs) -> nn.Module:
    if env_name not in INIT_EMBEDDING_REGISTRY:
        raise NotImplementedError(
            f"No init embedding ported for env '{env_name}' "
            f"(available: {sorted(INIT_EMBEDDING_REGISTRY)})"
        )
    return INIT_EMBEDDING_REGISTRY[env_name](embed_dim, **kwargs)
