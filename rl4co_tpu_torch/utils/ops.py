"""Tensor utilities (counterpart of `rl4co_tpu/utils/ops.py`).

Only what the evaluation path needs. The JAX package's custom-VJP gathers
and scatter-free index helpers work around TPU scatter lowering and have
no counterpart here: `torch.gather` and `scatter` do the same job.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a dict / dataclass / tensor tree."""
    if isinstance(x, torch.Tensor):
        return fn(x)
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
