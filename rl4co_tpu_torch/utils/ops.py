"""Tensor utilities (counterpart of `rl4co_tpu/utils/ops.py`).

Only what the evaluation path needs. The JAX package's custom-VJP gathers
and scatter-free index helpers work around TPU scatter lowering and have
no counterpart here: `torch.gather` and `scatter` do the same job.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a dict / dataclass / tensor tree;
    Python numbers (a cache's ``graph_context`` of 0.0) pass as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (int, float)):
        return x
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{
            f.name: tree_map(fn, getattr(x, f.name)) for f in dataclasses.fields(x)
        })
    raise TypeError(f"unsupported tree node {type(x).__name__}")


def gather_by_index(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``src`` along its node axis (-2), squeezing that axis.

    - ``src [B, N, D], idx [B] -> [B, D]``
    - ``src [B, N, D], idx [B, K] -> [B, K, D]``
    """
    idx = torch.as_tensor(idx, device=src.device).long()
    if src.ndim == 3 and idx.ndim == 1:
        index = idx[:, None, None].expand(-1, 1, src.shape[-1])
        return torch.gather(src, 1, index)[:, 0]
    if src.ndim == 3 and idx.ndim == 2:
        index = idx[:, :, None].expand(-1, -1, src.shape[-1])
        return torch.gather(src, 1, index)
    raise ValueError(
        f"Unsupported shapes src={tuple(src.shape)} idx={tuple(idx.shape)}"
    )


def xla_cpu_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU backend sums a row of
    f32: rows of up to 32 left to right; a longer row padded with zeros to
    a multiple of 32 (half the padding in front, rounded down), each window
    of 32 summed left to right, then the window sums the same way. Where a
    sum's last bit decides a mask (CVRPMVC's remaining demand against whole
    vehicles), this gives the JAX package's bit."""
    n = x.shape[-1]
    if n > 32:
        windows = -(-n // 32)
        pad = 32 * windows - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        return xla_cpu_sum(xla_cpu_sum(x.reshape(*x.shape[:-1], windows, 32)))
    total = x[..., 0]
    for j in range(1, n):
        total = total + x[..., j]
    return total


def get_distance_matrix(locs: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances ``[..., N, N]`` of ``locs [..., N, 2]``."""
    return torch.linalg.vector_norm(locs[..., :, None, :] - locs[..., None, :, :], dim=-1)


def get_tour_length(ordered_locs: torch.Tensor) -> torch.Tensor:
    """Closed-tour length of locations in visiting order, incl. return arc.
    Works on ``[N, 2]`` or ``[..., N, 2]``."""
    diffs = ordered_locs - torch.roll(ordered_locs, shifts=1, dims=-2)
    return torch.linalg.vector_norm(diffs, dim=-1).sum(dim=-1)


def batchify(x, repeats: int):
    """Tile a tree ``repeats`` times: ``[B, ...] -> [repeats * B, ...]`` in
    **repeat-major** layout ``(repeat, batch)``, so that :func:`unbatchify`
    with the same ``repeats`` inverts it."""

    def _one(a: torch.Tensor) -> torch.Tensor:
        if a.ndim == 0:
            return a
        return a.unsqueeze(0).expand(repeats, *a.shape).reshape(
            repeats * a.shape[0], *a.shape[1:]
        )

    return tree_map(_one, x)


def unbatchify(x, repeats: int):
    """Inverse of :func:`batchify`: ``[repeats * B, ...] -> [B, repeats, ...]``."""

    def _one(a: torch.Tensor) -> torch.Tensor:
        b = a.shape[0] // repeats
        return a.reshape(repeats, b, *a.shape[1:]).transpose(0, 1)

    return tree_map(_one, x)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``inv[b, perm[b, i]] = i`` for a batch of permutations ``[B, N]`` (the
    predecessor of each node of a linked-list tour), as a stable argsort: the
    JAX package's definition, which gives its result on any input."""
    return torch.argsort(perm, dim=-1, stable=True)


def scatter_permutation(perm: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[b, perm[b, i]] = values[b, i]`` when ``perm`` is a permutation,
    as the gather ``values[b, argsort(perm[b])]``."""
    return torch.gather(values, -1, inverse_permutation(perm))


def mark_vector_set(x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]] = values[b, j]`` for ``x [B, N]`` and index vectors
    ``[B, K]``; a repeated index takes the value of its last slot, as in the
    JAX package (a CUDA scatter would pick any of them)."""
    n, k = x.shape[-1], idx.shape[-1]
    hit = torch.arange(n, device=x.device)[None, :, None] == idx[:, None, :]   # [B, N, K]
    slots = torch.arange(k, device=x.device)
    last = torch.where(hit, slots, -1).amax(dim=-1)                            # [B, N]
    vals = torch.gather(values, -1, last.clamp(min=0))
    return torch.where(last >= 0, vals, x)
