"""Instance augmentation (counterpart of `rl4co_tpu/data/transforms.py`).

The 8 dihedral transforms of the unit square leave routing rewards
invariant; evaluation takes the max over them. ``symmetric`` augmentation
draws, per copy, a rotation about (0.5, 0.5) by an angle uniform in
[0, 2π) and a reflection with probability 1/2 (SymNCO's). Augmentation acts
on *instance dicts* before `env.reset`, expanding the batch repeat-major
(augment index is the outer axis), matching `batchify`, so
``unbatchify(x, num_augment)`` recovers ``[B, A]``. Copy 0 stays
untransformed either way.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from rl4co_tpu_torch.utils.ops import batchify


def dihedral_8_transform(xy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Apply the idx-th (0..7) dihedral-group transform to points in [0,1]^2.
    ``xy`` is ``[B, N, 2]`` and ``idx`` ``[B]``; idx 0 is the identity."""
    x, y = xy[..., 0], xy[..., 1]
    variants = torch.stack(
        [
            torch.stack([x, y], dim=-1),
            torch.stack([1 - x, y], dim=-1),
            torch.stack([x, 1 - y], dim=-1),
            torch.stack([1 - x, 1 - y], dim=-1),
            torch.stack([y, x], dim=-1),
            torch.stack([1 - y, x], dim=-1),
            torch.stack([y, 1 - x], dim=-1),
            torch.stack([1 - y, 1 - x], dim=-1),
        ],
        dim=0,
    )  # [8, B, N, 2]
    return variants[idx, torch.arange(xy.shape[0], device=xy.device)]


def symmetric_transform(xy: torch.Tensor, theta: torch.Tensor,
                        flip: torch.Tensor) -> torch.Tensor:
    """Rotate points ``xy [..., 2]`` about (0.5, 0.5) by ``theta`` (f32
    scalar), then, where ``flip`` (bool scalar), negate the rotated x."""
    c, s = torch.cos(theta), torch.sin(theta)
    cx, cy = xy[..., 0] - 0.5, xy[..., 1] - 0.5
    rx, ry = cx * c - cy * s, cx * s + cy * c
    rx = torch.where(flip, -rx, rx)
    return torch.stack([rx, ry], dim=-1) + 0.5


def symmetric_augment(instances: dict, theta: torch.Tensor, flip: torch.Tensor,
                      feats: Sequence[str] = ("locs", "depot")) -> dict:
    """``[A * B]`` copies (repeat-major), copy a > 0 transformed by
    ``symmetric_transform(·, theta[a], flip[a])``; copy 0 untransformed."""
    a = theta.shape[0]

    def apply(x):
        copies = [x] + [symmetric_transform(x, theta[i], flip[i]) for i in range(1, a)]
        return torch.cat(copies, dim=0)

    return {k: apply(v) if k in feats else batchify(v, a) for k, v in instances.items()}


def augment_instances(
    instances: dict,
    num_augment: int = 8,
    augment_fn: str = "dihedral8",
    generator: Optional[torch.Generator] = None,
    feats: Sequence[str] = ("locs", "depot"),
) -> dict:
    """Expand a batched instance dict to ``[A * B]`` (repeat-major) with the
    a-th copy transformed by the a-th augmentation.

    `dihedral8` requires ``num_augment == 8`` and keeps copy 0 untransformed.
    `symmetric` draws one angle and one reflection per copy from
    ``generator`` (on the instances' device), the angles first.
    """
    first = next(iter(instances.values()))
    if augment_fn == "symmetric":
        theta = torch.rand(num_augment, generator=generator, device=first.device) * 2 * math.pi
        flip = torch.rand(num_augment, generator=generator, device=first.device) < 0.5
        return symmetric_augment(instances, theta, flip, feats)
    if augment_fn != "dihedral8":
        raise ValueError(f"Unknown augment_fn {augment_fn}")
    if num_augment != 8:
        raise ValueError("dihedral8 augmentation requires num_augment=8")
    expanded = batchify(instances, num_augment)  # [A*B, ...]
    b = first.shape[0]
    aug_idx = torch.arange(8, device=first.device).repeat_interleave(b)  # [A*B]
    return {
        k: dihedral_8_transform(v, aug_idx) if k in feats else v
        for k, v in expanded.items()
    }
