"""Data, tensor and expert parallelism across processes (counterpart of
`rl4co_tpu/parallel/mesh.py`).

The JAX package builds a ``(dp, model)`` device mesh, shards the instances
over ``dp``, places parameters over ``model`` and lets GSPMD insert the
collectives. The port runs one process per device of the mesh, joined by
`torch.distributed`, laid out as the JAX package lays its devices
(``reshape(dp, model)``: process ``d * model + j`` is dp rank ``d``, model
rank ``j``).

**Data parallelism** (``dp``): each rank generates the global batch from the
same stream and keeps its own rows (`shard_batch`), the parameters start
from rank 0's (`replicate`), and the gradients are averaged across the dp
ranks after the backward (`Mesh.average_gradients`). The contract is the
JAX package's: a dp run is the same training run as a one-device run at the
same global batch. What couples the rows of a batch is made global over the
dp ranks while a train step runs on a rank's rows (`sharded`):

- batch norm takes its statistics from sums all-reduced over the global
  batch, with a backward that is global too (`all_reduce_sum`);
- the mean and exponential baselines and the logged metrics are global
  means (`global_mean`);
- a sampling rollout draws one uniform per global row (`uniform_rows`), so
  that each rank keeps its rows' draws of the one-process stream;
- the rollout baseline's epoch-end decision is rank 0's (`agree_with_rank0`).

The model ranks of one dp rank hold the same rows and draw the same
uniforms.

**Tensor and expert parallelism** (``model``): `shard_params_model_axis`
takes the JAX package's placement decision for every parameter (Megatron
pairs from the `TPDense` role markers or, without them, from the path
fragments; the column rule for any other 2-D kernel; the experts' leading
axis) and carries it out in eager form: a column-split layer computes its
share of the output features and either keeps them for the row-split layer
of its pair (whose partial products are summed over the model ranks) or
gathers them; the pointer head gathers its column-split ``[D, D]`` output
projection before each launch; an MoE evaluates its share of the experts
and sums the gate-weighted mix over the model ranks. The collectives are
Megatron's pairs (`copy_to_model`, `reduce_from_model`, `gather_from_model`).
Every replicated value is the same on every model rank, to the bit: the
tours, the logits fed to the pointer kernels (which run on whole tensors on
every rank, as GSPMD gathers in front of a ``pallas_call``) and the
replicated parameters.

The backend is NCCL when every process has a card of its own and gloo when
processes share a card or run on the CPU (NCCL refuses two ranks on one
device); gloo takes CUDA tensors through host copies of its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

# (dp, model) -> (default group, dp groups by model rank, model groups by dp rank)
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ``(dp, model)`` mesh: dp rank ``rank``
    of ``world`` dp ranks, model rank ``model_rank`` of ``model``. It holds
    integers only, so that a module holding its mesh deep-copies."""

    rank: int
    world: int
    model: int = 1
    model_rank: int = 0

    @property
    def process_rank(self) -> int:
        """The rank in the default process group: ``rank * model + model_rank``."""
        return self.rank * self.model + self.model_rank

    @property
    def dp_group(self):
        """The processes of this model rank, one per dp rank (the default
        group, ``None``, when ``model`` is 1)."""
        return None if self.model == 1 else _groups(self.world, self.model)[1][self.model_rank]

    @property
    def model_group(self):
        """The ``model`` processes of this dp rank."""
        return _groups(self.world, self.model)[2][self.rank]

    def local_batch(self, global_batch: int) -> int:
        if global_batch % self.world:
            raise ValueError(f"the global batch {global_batch} does not divide by the "
                             f"{self.world} data-parallel ranks")
        return global_batch // self.world

    def average_gradients(self, module: torch.nn.Module) -> None:
        """Every gradient of ``module`` replaced by its mean over the dp
        ranks, in one all-reduce of the gradients flattened together. Of a
        module that `shard_params_model_axis` split, a split parameter's
        gradient is averaged over the dp ranks of this model rank, and a
        replicated one's (the same on every model rank) over every process,
        which keeps the model ranks' copies equal to the bit."""
        split = {id(p) for _, p, _ in tp_parameters(module)}
        params = [p for p in module.parameters() if p.grad is not None]
        if self.model == 1:
            _mean_over([p.grad for p in params], None, self.world)
            return
        _mean_over([p.grad for p in params if id(p) not in split], None,
                   self.world * self.model)
        _mean_over([p.grad for p in params if id(p) in split], self.dp_group, self.world)

    def grad_norm(self, module: torch.nn.Module) -> torch.Tensor:
        """The global norm of ``module``'s gradients over every model rank's
        share of them (what clipping by global norm needs under tensor
        parallelism); the same on every model rank."""
        split = {id(p) for _, p, _ in tp_parameters(module)}
        own, rest = [], []
        for p in module.parameters():
            if p.grad is not None:
                (own if id(p) in split else rest).append(torch.linalg.vector_norm(p.grad))
        device = next(module.parameters()).device
        sq = torch.stack(rest).square().sum() if rest else torch.zeros((), device=device)
        own_sq = torch.stack(own).square().sum() if own else torch.zeros((), device=device)
        if self.model > 1:
            dist.all_reduce(own_sq, group=self.model_group)
        return (sq + own_sq).sqrt()


def _mean_over(grads: list, group, size: int) -> None:
    """``grads`` replaced by their mean over the ``size`` processes of ``group``."""
    if not grads or size == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _groups(dp: int, model: int):
    """The mesh's process groups, made once per default group: every
    process makes every group, in the same order (`make_mesh`)."""
    world = dist.group.WORLD
    entry = _GROUPS.get((dp, model))
    if entry is None or entry[0] is not world:
        entry = (world,
                 [dist.new_group([d * model + j for d in range(dp)]) for j in range(model)],
                 [dist.new_group([d * model + j for j in range(model)]) for d in range(dp)])
        _GROUPS[(dp, model)] = entry
    return entry


def init_distributed(device: str = "cuda", rank: Optional[int] = None,
                     world: Optional[int] = None, local_rank: Optional[int] = None,
                     addr: Optional[str] = None, port: Optional[int] = None):
    """Join the processes that the caller started (the counterpart of
    ``jax.distributed.initialize()``): each argument left out comes from
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. Returns ``(mesh, this rank's device)``: the mesh is
    every process on ``dp`` (`make_mesh` builds a ``model`` axis), the
    device ``cuda:<local rank modulo the cards>`` for ``"cuda"`` (raising
    without a card), else the device asked for."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world = int(env["WORLD_SIZE"]) if world is None else world
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    addr = env.get("MASTER_ADDR", "localhost") if addr is None else addr
    port = int(env["MASTER_PORT"]) if port is None else port
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--distributed on cuda: no CUDA device is visible")
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        # a card named in ``device`` is every local rank's
        shared = local_world > (1 if dev.index is not None else cards)
        dev = torch.device("cuda", local_rank % cards if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "gloo" if shared else "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world)
    return make_mesh(), dev


def make_mesh(dp: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(dp, model)`` mesh over the initialised process group (one
    process and no group: a mesh of one); ``dp`` defaults to the processes
    over ``model``. With ``model > 1`` every process must call it, since it
    makes the mesh's process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = world // model
    if dp * model != world:
        raise ValueError(f"dp({dp}) * model({model}) != ranks({world})")
    if model > 1:
        _groups(dp, model)
    return Mesh(rank=rank // model, world=dp, model=model, model_rank=rank % model)


def shard_batch(tree: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batched instance dict (the leading axis split
    into ``mesh.world`` equal blocks, in dp rank order)."""
    b = mesh.local_batch(next(iter(tree.values())).shape[0])
    lo = mesh.rank * b
    return {k: v[lo:lo + b] for k, v in tree.items()}


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's; a share
    that `shard_params_model_axis` split, to dp rank 0's of the same model
    rank."""
    if mesh.world * mesh.model == 1:
        return module
    split = {id(p) for _, p, _ in tp_parameters(module)}
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if id(t) in split:
                if mesh.world > 1:
                    dist.broadcast(t.data, src=mesh.model_rank, group=mesh.dp_group)
            else:
                dist.broadcast(t.data, src=0)
    return module


def agree_with_rank0(flag: bool) -> bool:
    """Rank 0's ``flag`` on every process (the flag itself without a group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    box = [flag]
    dist.broadcast_object_list(box, src=0)
    return bool(box[0])


# ---- the sharded train step ----


@dataclasses.dataclass(frozen=True)
class Shard:
    """A train step on this rank's ``local_batch`` instances of the mesh's
    global batch."""

    mesh: Mesh
    local_batch: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("shard", default=None)


@contextlib.contextmanager
def sharded(mesh: Mesh, local_batch: int):
    """Within the block the rows in hand are this rank's share of the global
    batch: batch statistics, means and draws are taken over the global one."""
    token = _SHARD.set(Shard(mesh, local_batch))
    try:
        yield
    finally:
        _SHARD.reset(token)


def active_shard() -> Optional[Shard]:
    return _SHARD.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes of ``group``; its backward sums the cotangents
    over them, so that each gets the gradient of the sum of every one's
    loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the dp ranks of the shard in force (``x`` itself
    outside one); differentiable."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return x
    return _AllReduceSum.apply(x, shard.mesh.dp_group)


def global_count(local: int) -> int:
    """The number of rows over the dp ranks of the shard in force."""
    shard = active_shard()
    return local if shard is None else local * shard.mesh.world


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every dp rank's rows (``x.mean()`` outside a
    shard); not differentiable across ranks."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return x.mean()
    total = x.detach().sum()
    dist.all_reduce(total, group=shard.mesh.dp_group)
    return total / (x.numel() * shard.mesh.world)


def global_means(metrics: dict) -> dict:
    """Each scalar of ``metrics`` (a mean over this rank's rows) averaged
    over the dp ranks, in one all-reduce."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1 or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    dist.all_reduce(flat, group=shard.mesh.dp_group)
    flat /= shard.mesh.world
    return dict(zip(names, flat.unbind()))


def uniform_rows(rows: int, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """One uniform in ``[0, 1)`` per row. In a shard the rows are ``R``
    repeat-major blocks of the rank's instances; the draw is that of the
    global ``R`` blocks of every dp rank's, of which this rank keeps its
    own (the model ranks of a dp rank keep the same)."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return torch.rand(rows, generator=generator, device=device)
    b, mesh = shard.local_batch, shard.mesh
    if rows % b:
        raise ValueError(f"{rows} rows are no whole number of blocks of {b} instances")
    u = torch.rand((rows // b, mesh.world, b), generator=generator, device=device)
    return u[:, mesh.rank].reshape(-1)


# ---- tensor and expert parallelism over ``model`` ----


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a parameter is split over the model ranks: ``kind`` is the
    decision (``"row"``, ``"col"`` or ``"expert"``), ``dim`` the axis of the
    port's tensor that is split, and ``groups`` the number of contiguous
    blocks along it that are each split into ``model`` shares (a fused
    QKV's 3: each rank holds whole heads of Q, K and V)."""

    kind: str
    dim: int
    groups: int = 1


def local_share(x: torch.Tensor, dim: int, groups: int, model: int, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s share of ``x`` along ``dim`` (a view)."""
    dim %= x.ndim
    n = x.shape[dim]
    if n % (groups * model):
        raise ValueError(f"{n} features along axis {dim} do not split into {groups} blocks "
                         f"over {model} model ranks")
    return x.unflatten(dim, (groups, model, n // (groups * model))).select(
        dim + 1, rank).flatten(dim, dim + 1)


def _assemble(parts: list, dim: int, groups: int) -> torch.Tensor:
    """The whole of which ``parts`` (in model rank order) are the shares."""
    dim %= parts[0].ndim
    return torch.stack([p.unflatten(dim, (groups, -1)) for p in parts],
                       dim=dim + 1).flatten(dim, dim + 2)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> list:
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
    return parts


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the identity, whose backward sums the cotangents of
    the model ranks (each saw only its share of the features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum of the model ranks' partial results, whose
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' shares along ``dim`` gathered whole; the backward
    keeps this rank's share of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim, groups):
        ctx.mesh, ctx.dim, ctx.groups = mesh, dim, groups
        return _assemble(_all_gather(x, mesh), dim, groups)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        share = local_share(grad, ctx.dim, ctx.groups, mesh.model, mesh.model_rank)
        return share.contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the model ranks."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model ranks (the same bits on each)."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int = -1,
                      groups: int = 1) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's share along ``dim``."""
    return _GatherFromModel.apply(x, mesh, dim, groups)


def gather_share(x: torch.Tensor, spec: ShardSpec, mesh: Mesh) -> torch.Tensor:
    """The whole of which ``x`` is this rank's share under ``spec`` (no
    gradient); every model rank must call it."""
    return _assemble(_all_gather(x, mesh), spec.dim, spec.groups)


def tp_parameters(module: torch.nn.Module) -> list:
    """``(state_dict name, parameter, (spec, mesh))`` of every parameter of
    ``module`` that `shard_params_model_axis` split."""
    out = []
    for prefix, mod in module.named_modules():
        for name, spec in getattr(mod, "tp_shards", {}).items():
            full = f"{prefix}.{name}" if prefix else name
            out.append((full, getattr(mod, name), (spec, mod.tp_mesh)))
    return out


def tp_param(module: torch.nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered from the model ranks
    when `shard_params_model_axis` split it (for a module that lists it in
    ``tp_gathered``), else as it is."""
    p = getattr(module, name)
    spec = getattr(module, "tp_shards", {}).get(name)
    return p if spec is None else gather_from_model(p, module.tp_mesh, spec.dim, spec.groups)


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` with every split parameter gathered whole:
    what one process would hold. Every model rank must call it."""
    state = module.state_dict()
    for name, _, (spec, mesh) in tp_parameters(module):
        state[name] = gather_share(state[name], spec, mesh)
    return state


def load_full_state_dict(module: torch.nn.Module, state: dict) -> None:
    """`load_state_dict` of a whole state (a one-process checkpoint, or
    `full_state_dict`'s) into a split ``module``: each rank takes its share."""
    state = dict(state)
    for name, _, (spec, mesh) in tp_parameters(module):
        state[name] = local_share(state[name], spec.dim, spec.groups, mesh.model,
                                  mesh.model_rank).clone()
    module.load_state_dict(state)


def _optimizer_slots(optimizer, module: torch.nn.Module) -> dict:
    """Index in ``optimizer.state_dict()["state"]`` -> (parameter, spec,
    mesh) of each split parameter of ``module``."""
    split = {id(p): sm for _, p, sm in tp_parameters(module)}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: (p, *split[id(p)]) for i, p in enumerate(params) if id(p) in split}


def full_optimizer_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module) -> dict:
    """``optimizer.state_dict()`` with the per-element state of every split
    parameter of ``module`` gathered whole. Every model rank must call it."""
    state = optimizer.state_dict()
    slots = _optimizer_slots(optimizer, module)
    out = {}
    for i, entry in state["state"].items():
        if i in slots:
            p, spec, mesh = slots[i]
            entry = {k: gather_share(v, spec, mesh) if _per_element(v, p) else v
                     for k, v in entry.items()}
        out[i] = entry
    return {**state, "state": out}


def local_optimizer_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                          state: dict) -> dict:
    """A whole optimizer state (`full_optimizer_state`'s, or one process's)
    with each split parameter's per-element state cut to this rank's share."""
    slots = _optimizer_slots(optimizer, module)
    out = {}
    for i, entry in state["state"].items():
        if i in slots:
            p, spec, mesh = slots[i]
            entry = {k: local_share(v, spec.dim, spec.groups, mesh.model, mesh.model_rank).clone()
                     if _per_element(v, p, mesh.model, spec.dim) else v
                     for k, v in entry.items()}
        out[i] = entry
    return {**state, "state": out}


def _per_element(v, p: torch.Tensor, model: int = 1, dim: int = 0) -> bool:
    """Whether optimizer state ``v`` has one value per element of the
    parameter ``p`` (its share; times ``model`` along ``dim`` when whole)."""
    if not isinstance(v, torch.Tensor) or v.ndim != p.ndim:
        return False
    want = list(p.shape)
    want[dim] *= model
    return list(v.shape) == want


# Fallback path fragments of the second matmul of a Megatron pair: its input
# features are already split by the first, so splitting its rows keeps the
# intermediate split and needs one reduction per block. Used only when no
# `roles` are given; the robust path is the TPDense role markers.
_ROW_SHARDED = ("ffn']['Dense_1", "mha']['out_proj")


def tp_role_lookup(roles) -> dict:
    """Flatten a TPDense marker tree (`policy_tp_roles`) into
    ``{module path: role}``, paths ``/``-joined, e.g.
    ``encoder_net/layer_0/mha/out_proj``."""
    out = {}

    def walk(node, keys):
        for key, val in node.items():
            if key == "tp_role" and isinstance(val, str):
                out["/".join(keys)] = val
            elif isinstance(val, dict):
                walk(val, keys + [str(key)])

    walk(roles, [])
    return out


def _jax_leaves(module: torch.nn.Module):
    """``(JAX path, JAX shape, owner, attribute)`` of every parameter: an
    ``nn.Linear``'s weight is the JAX package's ``kernel [in, out]``, every
    other parameter keeps its name and layout (`rl4co_tpu_torch.convert`)."""
    for prefix, mod in module.named_modules():
        keys = tuple(prefix.split(".")) if prefix else ()
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, torch.nn.Linear) and name == "weight":
                yield keys + ("kernel",), tuple(p.shape[::-1]), mod, name
            else:
                yield keys + (name,), tuple(p.shape), mod, name


def _decide(path: tuple, shape: tuple, lookup: Optional[dict], model: int,
            min_dim: int) -> str:
    """The JAX package's placement of a leaf (`shard_params_model_axis`
    there): ``"expert"`` for ``P('model', ...)`` under an ``experts`` scope,
    ``"row"`` for ``P('model', None)``, ``"col"`` for ``P(None, 'model')``,
    else ``"replicated"``."""
    nd = len(shape)
    if model > 1 and nd >= 1:
        name = "".join(f"['{k}']" for k in ("params",) + path)
        if "experts']" in name and shape[0] % model == 0:
            return "expert"
        if nd == 2:
            if lookup is not None:
                row = lookup.get("/".join(path[:-1]), "none") == "row"
            else:
                row = any(f in name for f in _ROW_SHARDED)
            if row and shape[0] % model == 0 and shape[0] >= min_dim:
                return "row"
            if shape[1] % model == 0 and shape[1] >= min_dim:
                return "col"
    return "replicated"


def _role_lookup(roles) -> Optional[dict]:
    """``roles`` as ``{module path: role}``, None for no markers."""
    if roles is None:
        return None
    lookup = roles if (isinstance(roles, dict) and roles
                       and all(isinstance(v, str) for v in roles.values())) \
        else tp_role_lookup(roles)
    return lookup or None   # an empty marker tree must not disable the row rule


def tp_decisions(policy: torch.nn.Module, model: int, min_dim: int = 128,
                 roles=None) -> dict:
    """``{JAX parameter path: decision}`` of `shard_params_model_axis` over
    ``model`` ranks, without placing anything."""
    lookup = _role_lookup(roles)
    return {"/".join(path): _decide(path, shape, lookup, model, min_dim)
            for path, shape, _, _ in _jax_leaves(policy)}


def shard_params_model_axis(policy: torch.nn.Module, mesh: Mesh, min_dim: int = 128,
                            roles=None) -> dict:
    """Tensor- and expert-parallel placement of ``policy`` over the mesh's
    ``model`` axis, the JAX package's decisions carried out eagerly (every
    process calls it, once, before training; with ``model == 1`` it is
    `replicate`). Returns `tp_decisions`: ``{JAX parameter path: decision}``
    for every parameter, ``"row"``, ``"col"``, ``"expert"`` or
    ``"replicated"``.

    The decisions, in the JAX package's order: a leaf under an ``experts``
    scope whose leading (expert) axis divides by ``model`` is split along it;
    a 2-D kernel marked ``row`` (by ``roles``, else by the path fragments
    ``ffn/Dense_1`` and ``mha/out_proj``) with at least ``min_dim`` input
    features dividing by ``model`` is split along them; any other 2-D
    kernel with at least ``min_dim`` output features dividing by ``model``
    along those; everything else is replicated. ``roles`` is
    `policy_tp_roles`' tree or `tp_role_lookup`'s dict (an empty one counts
    as none).

    What each becomes: the column-split layers of a Megatron pair (a fused
    QKV, split by whole heads; the FFN's first layer) keep their share of
    the features for the row-split layer, which sums its partial products
    over the model ranks; any other column-split layer gathers its output,
    and a column-split raw kernel (the pointer's ``project_out_kernel``) is
    gathered before use; an MoE runs its share of the experts and sums the
    gate-weighted mix. A placement with no eager form raises
    `NotImplementedError`, heads that do not divide by ``model`` raise
    `ValueError`, before anything moves. Every process then takes rank 0's
    parameters and keeps its share."""
    decisions = tp_decisions(policy, mesh.model, min_dim, roles)
    plan = None
    if mesh.model > 1:
        if tp_parameters(policy):
            raise ValueError("the policy is split already")
        plan = _plan(policy, decisions, mesh.model)
    replicate(policy, mesh)   # nothing split yet: process 0's weights everywhere
    if plan is not None:
        _carry_out(policy, plan, mesh)
    return decisions


def _plan(policy, decisions: dict, m: int) -> dict:
    """What `shard_params_model_axis` does to each module, checked whole
    before anything changes."""
    leaves = list(_jax_leaves(policy))
    decision = {(id(owner), name): decisions["/".join(path)]
                for path, _, owner, name in leaves}

    def of(mod, name):
        return decision.get((id(mod), name), "replicated")

    modules = dict(policy.named_modules())
    plan = {"pairs": [], "linear": {}, "raw": [], "experts": [], "expert_leaves": []}
    for name, mod in modules.items():
        for feeders, row, groups in getattr(mod, "tp_pairs", ()):
            if of(getattr(mod, row), "weight") != "row":
                continue
            if any(of(getattr(mod, f), "weight") != "col" for f in feeders):
                raise NotImplementedError(f"{name}.{row} is split by rows but not every "
                                          f"layer feeding it by columns")
            heads = getattr(mod, "num_heads", None)
            if heads is not None and heads % m:
                raise ValueError(f"{name}: {heads} heads do not split over {m} model ranks")
            plan["pairs"].append(mod)
            prefix = f"{name}." if name else ""
            plan["linear"][prefix + row] = ("row", 1)
            for f, g in zip(feeders, groups):
                plan["linear"][prefix + f] = ("col_local", g)
    for name, mod in modules.items():
        if hasattr(mod, "tp_experts"):
            split = [of(owner, leaf) == "expert" for owner, leaf in mod.tp_experts()]
            if any(split) and not all(split):
                raise NotImplementedError(f"{name}: only some of its experts' parameters split")
            if split and all(split):
                plan["experts"].append(mod)
    expert_owners = {id(owner) for mod in plan["experts"] for owner, _ in mod.tp_experts()}
    for path, _, owner, leaf in leaves:
        kind, where = of(owner, leaf), "/".join(path)
        if kind == "replicated" or (isinstance(owner, torch.nn.Linear) and leaf == "weight"):
            continue
        if kind == "expert" and id(owner) in expert_owners:
            plan["expert_leaves"].append((owner, leaf))
        elif kind == "col" and leaf in getattr(owner, "tp_gathered", ()):
            plan["raw"].append((owner, leaf))
        else:
            raise NotImplementedError(f"{where}: a {kind}-split parameter of shape "
                                      f"{tuple(getattr(owner, leaf).shape)} that no module "
                                      f"of the port runs split")
    for name, mod in modules.items():
        if isinstance(mod, torch.nn.Linear) and of(mod, "weight") != "replicated":
            kind = of(mod, "weight")
            mode, _ = plan["linear"].setdefault(name, ("col_gather", 1))
            if (kind == "row") != (mode == "row"):
                raise NotImplementedError(f"{name}: a {kind}-split layer outside a Megatron pair")
    return plan


def _carry_out(policy: torch.nn.Module, plan: dict, mesh: Mesh) -> None:
    from rl4co_tpu_torch.models.nn.ops import TPDense

    modules = dict(policy.named_modules())
    with torch.no_grad():
        for mod in plan["pairs"]:
            tp_local = getattr(mod, "tp_local", None)
            if tp_local is not None:
                tp_local(mesh.model)
        for name, (mode, groups) in plan["linear"].items():
            mod = modules[name]
            if not isinstance(mod, TPDense):   # a plain Linear, column-split
                parent, _, child = name.rpartition(".")
                mod = modules[parent]._modules[child] = TPDense.sharing(mod)
            mod.tp_mode, mod.tp_groups = mode, groups
            spec = ShardSpec("row", 1) if mode == "row" else ShardSpec("col", 0, groups)
            _split(mod, "weight", spec, mesh)
        for owner, leaf in plan["raw"]:
            _split(owner, leaf, ShardSpec("col", 1), mesh)
        for owner, leaf in plan["expert_leaves"]:
            _split(owner, leaf, ShardSpec("expert", 0), mesh)
        for mod in plan["experts"]:
            mod.tp_mesh = mesh


def _split(module: torch.nn.Module, name: str, spec: ShardSpec, mesh: Mesh) -> None:
    """Keep this rank's share of ``module``'s parameter ``name`` (the same
    parameter object, so an optimiser built on it still holds it)."""
    p = getattr(module, name)
    p.data = local_share(p.data, spec.dim, spec.groups, mesh.model, mesh.model_rank).clone()
    if not hasattr(module, "tp_shards"):
        module.tp_shards = {}
    module.tp_shards[name] = spec
    module.tp_mesh = mesh
