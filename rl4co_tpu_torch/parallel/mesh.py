"""Data parallelism across processes (counterpart of `rl4co_tpu/parallel/mesh.py`).

The JAX package builds a ``(dp, model)`` device mesh, shards the instances
over ``dp`` and lets GSPMD insert the gradient all-reduce. The port runs one
process per rank, joined by `torch.distributed`: each rank generates the
global batch from the same stream and keeps its own rows (`shard_batch`),
the parameters start from rank 0's (`replicate`), and the gradients are
averaged across ranks after the backward (`Mesh.average_gradients`).

The contract is the JAX package's: a dp run is the same training run as a
one-device run at the same global batch. What couples the rows of a batch
is made global while a train step runs on a rank's rows (`sharded`):

- batch norm takes its statistics from sums all-reduced over the global
  batch, with a backward that is global too (`all_reduce_sum`);
- the mean and exponential baselines and the logged metrics are global
  means (`global_mean`);
- a sampling rollout draws one uniform per global row (`uniform_rows`), so
  that each rank keeps its rows' draws of the one-process stream;
- the rollout baseline's epoch-end decision is rank 0's (`agree_with_rank0`).

The backend is NCCL when every process has a card of its own and gloo when
processes share a card or run on the CPU (NCCL refuses two ranks on one
device); gloo takes CUDA tensors through host copies of its own.

Tensor and expert parallelism (the ``model`` axis: `shard_params_model_axis`,
`tp_role_lookup`, `TPDense`) are GSPMD placement annotations with no eager
counterpart short of a DTensor redesign; ``model`` must be 1 here, where the
JAX package's placement is `replicate` (ROADMAP.md, not ported on purpose).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``dp`` ranks of the default process group: this process's rank
    and the world size."""

    rank: int
    world: int

    def local_batch(self, global_batch: int) -> int:
        if global_batch % self.world:
            raise ValueError(f"the global batch {global_batch} does not divide by the "
                             f"{self.world} data-parallel ranks")
        return global_batch // self.world

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every gradient replaced by its mean over the ranks (one all-reduce
        of the gradients flattened together)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads or self.world == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def init_distributed(device: str = "cuda", rank: Optional[int] = None,
                     world: Optional[int] = None, local_rank: Optional[int] = None,
                     addr: Optional[str] = None, port: Optional[int] = None):
    """Join the processes that the caller started (the counterpart of
    ``jax.distributed.initialize()``): each argument left out comes from
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. Returns ``(mesh, this rank's device)``: ``cuda:<local
    rank modulo the cards>`` for ``"cuda"`` (raising without a card), else
    the device asked for."""
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
    """The ``(dp, model)`` mesh over the initialised process group (one rank
    and no group: a mesh of one)."""
    if model != 1:
        raise NotImplementedError(
            "model > 1: tensor and expert parallelism are not ported (ROADMAP.md)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is not None and dp != world:
        raise ValueError(f"dp({dp}) * model({model}) != ranks({world})")
    return Mesh(rank=rank, world=world)


def shard_batch(tree: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batched instance dict (the leading axis split
    into ``mesh.world`` equal blocks, in rank order)."""
    b = mesh.local_batch(next(iter(tree.values())).shape[0])
    lo = mesh.rank * b
    return {k: v[lo:lo + b] for k, v in tree.items()}


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def agree_with_rank0(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (the flag itself without a group)."""
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
    """Sum over the ranks; its backward sums the cotangents over the ranks,
    so that each rank gets the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the shard in force (``x`` itself
    outside one); differentiable."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return x
    return _AllReduceSum.apply(x)


def global_count(local: int) -> int:
    """The number of rows over the ranks of the shard in force."""
    shard = active_shard()
    return local if shard is None else local * shard.mesh.world


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every rank's rows (``x.mean()`` outside a
    shard); not differentiable across ranks."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return x.mean()
    total = x.detach().sum()
    dist.all_reduce(total)
    return total / (x.numel() * shard.mesh.world)


def global_means(metrics: dict) -> dict:
    """Each scalar of ``metrics`` (a mean over this rank's rows) averaged
    over the ranks, in one all-reduce."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1 or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    dist.all_reduce(flat)
    flat /= shard.mesh.world
    return dict(zip(names, flat.unbind()))


def uniform_rows(rows: int, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """One uniform in ``[0, 1)`` per row. In a shard the rows are ``R``
    repeat-major blocks of the rank's instances; the draw is that of the
    global ``R`` blocks of every rank's, of which this rank keeps its own."""
    shard = active_shard()
    if shard is None or shard.mesh.world == 1:
        return torch.rand(rows, generator=generator, device=device)
    b, mesh = shard.local_batch, shard.mesh
    if rows % b:
        raise ValueError(f"{rows} rows are no whole number of blocks of {b} instances")
    u = torch.rand((rows // b, mesh.world, b), generator=generator, device=device)
    return u[:, mesh.rank].reshape(-1)
