"""Instance augmentation (counterpart of `rl4co_tpu/data/transforms.py`).

The 8 dihedral transforms of the unit square leave routing rewards
invariant; evaluation takes the max over them. Augmentation acts on
*instance dicts* before `env.reset`, expanding the batch repeat-major
(augment index is the outer axis), matching `batchify`, so
``unbatchify(x, num_augment)`` recovers ``[B, A]``.
"""

from __future__ import annotations

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
    """
    if augment_fn == "symmetric":
        raise NotImplementedError(
            "symmetric augmentation is not ported yet (see ROADMAP.md)"
        )
    if augment_fn != "dihedral8":
        raise ValueError(f"Unknown augment_fn {augment_fn}")
    if num_augment != 8:
        raise ValueError("dihedral8 augmentation requires num_augment=8")
    expanded = batchify(instances, num_augment)  # [A*B, ...]
    first = next(iter(instances.values()))
    b = first.shape[0]
    aug_idx = torch.arange(8, device=first.device).repeat_interleave(b)  # [A*B]
    return {
        k: dihedral_8_transform(v, aug_idx) if k in feats else v
        for k, v in expanded.items()
    }
