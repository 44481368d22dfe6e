"""Plain float32 reference of the Attention Model family on TSP and CVRP.

Written from the published descriptions (Kool, van Hoof, Welling, "Attention,
Learn to Solve Routing Problems!", ICLR 2019; Kwon et al., "POMO", NeurIPS
2020) and rl4co's defaults, in plain `torch` operations: no kernel, no cache
shared between queries beyond the instance's own keys, nothing of the
program under test. It imports `torch` alone.

The model, as a configuration file of `portbench/configs/` states it:

- initial embedding: TSP ``Linear(2, D)`` on the coordinates; CVRP
  ``Linear(2, D)`` on the depot and ``Linear(3, D)`` on (x, y, demand) of
  each customer, the depot first;
- ``L`` encoder layers, post-norm: ``h = Norm(x + MHA(x))``,
  ``x = Norm(h + FFN(h))``, MHA with one fused q/k/v projection (biases)
  and an output projection, FFN ``Linear(D, F)``, ReLU, ``Linear(F, D)``;
  batch norm over (instances, nodes) with the statistics of the batch at
  hand and the biased variance, or instance norm over each instance's
  nodes; eps 1e-5, a scale and a bias per channel;
- decoder: glimpse keys, glimpse values and logit keys from one
  ``Linear(D, 3D)`` (no bias) of the node embeddings; a graph context
  ``Linear(D, D)`` of their mean where the configuration has one; a step
  context (TSP: the first and current nodes' embeddings, a learned
  placeholder, less 1, before the first step; CVRP: the current node's
  embedding and the remaining capacity) through ``Linear(., D)`` (no bias);
  a masked multi-head glimpse (masked scores set to -1e9), its ``D x D``
  output projection used as ``x @ W``, logits ``glimpse . logit_key / sqrt(D)``,
  tanh clipping, the mask (-1e9) and a log-softmax;
- greedy steps take the first largest logit; sampled steps draw by the
  inverse of the cumulative distribution at one uniform per row, a masked
  draw replaced by the greedy action; multistart forces the first action.

Weights are a dict of tensors named as `param_schema` lists them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MASK = -1e9
NORM_EPS = 1e-5
CAPACITY_SLACK = 1e-5


def param_schema(cfg: dict) -> list:
    """``[(name, shape, (kind, a, b))]``: every weight of the configuration,
    with the distribution the benchmark draws it from (``uniform`` on
    ``[-a, a)`` with ``a = 1/sqrt(fan_in)``, ``range`` on ``[a, b)``,
    ``const`` equal to ``a``)."""
    d, f, layers = cfg["embed_dim"], cfg["feedforward_hidden"], cfg["num_encoder_layers"]

    def lin(name, fan_out, fan_in, bias=True):
        a = 1.0 / math.sqrt(fan_in)
        out = [(name + ".weight", (fan_out, fan_in), ("uniform", a, 0.0))]
        if bias:
            out.append((name + ".bias", (fan_out,), ("uniform", a, 0.0)))
        return out

    schema = []
    if cfg["env"] == "tsp":
        schema += lin("init_embedding.init_embed", d, 2)
    else:
        schema += lin("init_embedding.init_embed_depot", d, 2)
        schema += lin("init_embedding.init_embed", d, 3)
    for i in range(layers):
        p = f"encoder_net.layer_{i}."
        schema += lin(p + "mha.Wqkv", 3 * d, d) + lin(p + "mha.out_proj", d, d)
        schema += [(p + "norm1.scale", (d,), ("const", 1.0, 0.0)),
                   (p + "norm1.bias", (d,), ("const", 0.0, 0.0))]
        schema += lin(p + "ffn.Dense_0", f, d) + lin(p + "ffn.Dense_1", d, f)
        schema += [(p + "norm2.scale", (d,), ("const", 1.0, 0.0)),
                   (p + "norm2.bias", (d,), ("const", 0.0, 0.0))]
    if cfg["env"] == "tsp":
        schema.append(("context_embedding.W_placeholder", (2 * d,), ("range", 0.0, 2.0)))
        schema += lin("context_embedding.project_context", d, 2 * d, bias=False)
    else:
        schema += lin("context_embedding.project_context", d, d + 1, bias=False)
    schema += lin("project_node_embeddings", 3 * d, d, bias=False)
    if cfg["use_graph_context"]:
        schema += lin("project_fixed_context", d, d, bias=False)
    schema.append(("pointer.project_out_kernel", (d, d), ("uniform", 1.0 / math.sqrt(d), 0.0)))
    return schema


def num_nodes(cfg: dict) -> int:
    """Nodes the decoder points at: the cities, or the depot and the customers."""
    return cfg["num_loc"] + (0 if cfg["env"] == "tsp" else 1)


def max_steps(cfg: dict) -> int:
    """Decode steps of a rollout: every city once (TSP), or at worst a depot
    visit after every customer (CVRP)."""
    return cfg["num_loc"] if cfg["env"] == "tsp" else 2 * cfg["num_loc"]


def _linear(x, w, b=None):
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def _norm(x, kind, scale, bias):
    dims = (0, 1) if kind == "batch" else (1,)
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + NORM_EPS) * scale + bias


def _heads(x, h):
    """[B, S, D] -> [B, H, S, D/H]"""
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).permute(0, 2, 1, 3)


def _merge(x):
    """[B, H, S, D/H] -> [B, S, D]"""
    b, h, s, e = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * e)


def encode(w: dict, cfg: dict, inst: dict) -> torch.Tensor:
    """Node embeddings ``[B, nodes, D]``."""
    if cfg["env"] == "tsp":
        x = _linear(inst["locs"], w["init_embedding.init_embed.weight"],
                    w["init_embedding.init_embed.bias"])
    else:
        depot = _linear(inst["depot"][:, None, :], w["init_embedding.init_embed_depot.weight"],
                        w["init_embedding.init_embed_depot.bias"])
        feats = torch.cat([inst["locs"], inst["demand"][..., None]], dim=-1)
        x = torch.cat([depot, _linear(feats, w["init_embedding.init_embed.weight"],
                                      w["init_embedding.init_embed.bias"])], dim=1)
    h, kind = cfg["num_heads"], cfg["normalization"]
    for i in range(cfg["num_encoder_layers"]):
        p = f"encoder_net.layer_{i}."
        qkv = _linear(x, w[p + "mha.Wqkv.weight"], w[p + "mha.Wqkv.bias"])
        q, k, v = (_heads(t, h) for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = _merge(torch.matmul(torch.softmax(scores, dim=-1), v))
        x = _norm(x + _linear(att, w[p + "mha.out_proj.weight"], w[p + "mha.out_proj.bias"]),
                  kind, w[p + "norm1.scale"], w[p + "norm1.bias"])
        ff = _linear(torch.relu(_linear(x, w[p + "ffn.Dense_0.weight"], w[p + "ffn.Dense_0.bias"])),
                     w[p + "ffn.Dense_1.weight"], w[p + "ffn.Dense_1.bias"])
        x = _norm(x + ff, kind, w[p + "norm2.scale"], w[p + "norm2.bias"])
    return x


def _gather(h, idx):
    """Rows ``idx [B, S]`` of ``h [B, N, D]`` -> ``[B, S, D]``."""
    return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


class _Env:
    """TSP or CVRP over ``[B, S]`` trajectories (S starts or samples of each
    instance)."""

    def __init__(self, cfg, inst, s):
        self.tsp = cfg["env"] == "tsp"
        if self.tsp:
            self.locs = inst["locs"]
        else:
            self.locs = torch.cat([inst["depot"][:, None, :], inst["locs"]], dim=1)
            self.demand = inst["demand"]
        b, n = self.locs.shape[:2]
        dev = self.locs.device
        self.first = torch.zeros((b, s), dtype=torch.long, device=dev)
        self.cur = torch.zeros((b, s), dtype=torch.long, device=dev)
        self.used = torch.zeros((b, s), device=dev)
        self.visited = torch.zeros((b, s, n), dtype=torch.bool, device=dev)
        self.done = torch.zeros((b, s), dtype=torch.bool, device=dev)
        self.t = 0

    def mask(self):
        if self.tsp:
            feasible = ~self.visited
            pad = torch.zeros_like(feasible).scatter(2, self.cur[..., None], True)
        else:
            exceeds = self.demand[:, None, :] + self.used[..., None] > 1.0 + CAPACITY_SLACK
            blocked = self.visited[..., 1:] | exceeds
            depot_blocked = (self.cur == 0) & (~blocked).any(dim=-1)
            feasible = torch.cat([~depot_blocked[..., None], ~blocked], dim=-1)
            pad = torch.zeros_like(feasible)
            pad[..., 0] = True
        return torch.where(self.done[..., None], pad, feasible)

    def step(self, a):
        live = ~self.done
        if self.tsp:
            if self.t == 0:
                self.first = a
        else:
            dem = torch.gather(self.demand, 1, (a - 1).clamp(min=0))
            used = torch.where(a == 0, 0.0, self.used + dem)
            self.used = torch.where(live, used, self.used)
        visited = self.visited.scatter(2, a[..., None], True)
        self.visited = torch.where(live[..., None], visited, self.visited)
        self.cur = torch.where(live, a, self.cur)
        self.done = self.done | self.visited.all(dim=-1)
        self.t += 1

    def tour_length(self, actions):
        """Closed tour over ``actions [B, S, T]``, from the depot for CVRP."""
        b, s, t = actions.shape
        idx = actions.reshape(b, s * t)
        pts = torch.gather(self.locs, 1, idx[..., None].expand(-1, -1, 2)).reshape(b, s, t, 2)
        if not self.tsp:
            depot = self.locs[:, None, None, 0, :].expand(b, s, 1, 2)
            pts = torch.cat([depot, pts], dim=2)
        diffs = pts - torch.roll(pts, shifts=1, dims=2)
        return torch.sqrt(diffs.square().sum(dim=-1)).sum(dim=-1)


def _step_logits(w, cfg, h, cache, env):
    """Clipped, masked logits ``[B, S, nodes]`` and the mask."""
    gk, gv, lk, gctx = cache
    d, nh = cfg["embed_dim"], cfg["num_heads"]
    if env.tsp:
        ctx = torch.cat([_gather(h, env.first), _gather(h, env.cur)], dim=-1)
        if env.t == 0:
            ctx = (w["context_embedding.W_placeholder"] - 1.0).expand_as(ctx)
    else:
        ctx = torch.cat([_gather(h, env.cur), (1.0 - env.used)[..., None]], dim=-1)
    q = _linear(ctx, w["context_embedding.project_context.weight"]) + gctx
    mask = env.mask()
    scores = torch.matmul(_heads(q, nh), _heads(gk, nh).transpose(-1, -2)) / math.sqrt(d // nh)
    scores = scores.masked_fill(~mask[:, None], MASK)
    glimpse = _merge(torch.matmul(torch.softmax(scores, dim=-1), _heads(gv, nh)))
    glimpse = torch.matmul(glimpse, w["pointer.project_out_kernel"])
    logits = torch.matmul(glimpse, lk.transpose(-1, -2)) / math.sqrt(d)
    logits = torch.tanh(logits) * cfg["tanh_clipping"]
    return logits.masked_fill(~mask, MASK), mask


def precompute(w, cfg, h):
    gk, gv, lk = _linear(h, w["project_node_embeddings.weight"]).chunk(3, dim=-1)
    if cfg["use_graph_context"]:
        gctx = _linear(h.mean(dim=1), w["project_fixed_context.weight"])[:, None, :]
    else:
        gctx = torch.zeros((), device=h.device)
    return gk, gv, lk, gctx


def start_nodes(cfg, s, device):
    """Multistart's first actions: every city, or every customer (never the depot)."""
    first = 0 if cfg["env"] == "tsp" else 1
    return torch.arange(first, first + s, device=device)


def rollout(w: dict, cfg: dict, inst: dict, starts: int = 0, mode: str = "greedy",
            uniforms: Optional[list] = None, actions: Optional[torch.Tensor] = None,
            h: Optional[torch.Tensor] = None) -> dict:
    """A rollout of every instance of ``inst``.

    ``starts`` > 0: that many trajectories per instance, the i-th forced to
    start at `start_nodes`' i-th (in ``force`` mode: the first action was
    forced, so it is neither scored nor counted); 0: one trajectory.
    ``mode``: ``greedy``; ``sample`` (``uniforms``: one ``[B]`` tensor per
    step, one trajectory per instance); ``force`` (``actions [B, S, T]``:
    the trajectories replayed). ``h``: the node embeddings, if already
    encoded. Returns ``actions [B, S, T]``, ``ll [B, S]`` (the chosen
    actions' log-probabilities summed over live steps), ``cost [B, S]`` (tour
    length) and, in ``force`` mode, ``gap [B, S]``: the largest amount by
    which a replayed action's logit lies below the best logit of its step,
    over the steps the trajectory chose.
    """
    if h is None:
        h = encode(w, cfg, inst)
    b = h.shape[0]
    s = max(starts, 1) if actions is None else actions.shape[1]
    cache = precompute(w, cfg, h)
    env = _Env(cfg, inst, s)
    taken, ll = [], torch.zeros((b, s), device=h.device)
    gap = torch.zeros((b, s), device=h.device)
    forced_first = starts > 0
    for t in range(max_steps(cfg)):
        logits, mask = _step_logits(w, cfg, h, cache, env)
        logp = torch.log_softmax(logits, dim=-1)
        if mode == "force":
            a = actions[..., t]
        elif t == 0 and forced_first:
            a = start_nodes(cfg, s, h.device)[None, :].expand(b, s)
        elif mode == "greedy":
            a = logits.argmax(dim=-1)
        elif mode == "sample":
            cdf = logp.exp().cumsum(dim=-1)
            u = uniforms[t].reshape(b, s)
            a = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None], right=True)[..., 0]
            a = a.clamp(max=cdf.shape[-1] - 1)
            bad = ~torch.gather(mask, -1, a[..., None])[..., 0]
            a = torch.where(bad, logits.argmax(dim=-1), a)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        chosen = torch.gather(logp, -1, a[..., None])[..., 0]
        if not (t == 0 and forced_first):
            ll = ll + torch.where(env.done, 0.0, chosen)
            if mode == "force":
                step_gap = logits.max(dim=-1).values - torch.gather(logits, -1, a[..., None])[..., 0]
                gap = torch.maximum(gap, torch.where(env.done, 0.0, step_gap.detach()))
        taken.append(a)
        env.step(a)
    acts = torch.stack(taken, dim=-1)
    out = {"actions": acts, "ll": ll, "cost": env.tour_length(acts)}
    if mode == "force":
        # a replay that leaves an instance unfinished answers nothing
        out["gap"] = torch.where(env.done, gap, torch.full_like(gap, float("inf")))
    return out


def dihedral8(xy: torch.Tensor) -> torch.Tensor:
    """The 8 symmetries of the unit square applied to points ``[B, ..., 2]``:
    ``[8, B, ..., 2]``, the identity first."""
    x, y = xy[..., 0], xy[..., 1]
    pairs = [(x, y), (1 - x, y), (x, 1 - y), (1 - x, 1 - y),
             (y, x), (1 - y, x), (y, 1 - x), (1 - y, 1 - x)]
    return torch.stack([torch.stack(p, dim=-1) for p in pairs])


def augment8(inst: dict) -> dict:
    """``[8 * B]`` copies, copy-major, each under its symmetry."""
    out = {}
    for k, v in inst.items():
        if k in ("locs", "depot"):
            out[k] = dihedral8(v).reshape(-1, *v.shape[1:])
        else:
            out[k] = v.repeat(8, *([1] * (v.ndim - 1)))
    return out
