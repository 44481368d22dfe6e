"""Checkpoint / resume (counterpart of `rl4co_tpu/checkpoint.py`, which uses
Orbax), over `torch.save` / `torch.load`.

A checkpoint is one file holding a tree of tensors, numbers, strings, lists
and dicts: what the trainer's `_ckpt_tree` gathers (the algorithm's
``state_dict`` with policy, optimiser, schedule index, baseline state and the
snapshot's weights, plus epoch, ``best_monitor`` and the rollout baseline's
``eval_rewards``). It is written to a temporary name and renamed, so a run
killed while saving leaves the previous file whole. Loading admits tensors and
plain containers only (``weights_only=True``) and says where the tensors
go: ``map_location`` has no default.

Orbax directories of the JAX package are not read here; its weights come in
through `rl4co_tpu_torch.convert.load_params`.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, tree: Any) -> str:
    """Save ``tree`` to the file ``path``; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, map_location) -> Any:
    """Load the tree saved at ``path`` with its tensors on ``map_location``
    (``"cpu"``, ``"cuda"``, a `torch.device`)."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
