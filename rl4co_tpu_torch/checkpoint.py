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

With a ``step``, `save_checkpoint` writes ``<path>/step_<step>.pt``, and
`latest_step_dir` finds the highest such entry under a directory (a file of
the port or, as the JAX package lays them out, a ``step_<n>`` directory).
Orbax directories of the JAX package are not read here; its weights come in
through `rl4co_tpu_torch.convert.load_params`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_STEP = re.compile(r"step_(\d+)(\.pt)?$")


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Save ``tree`` to the file ``path`` (with ``step``: to
    ``<path>/step_<step>.pt``); returns the absolute path."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, map_location) -> Any:
    """Load the tree saved at ``path`` with its tensors on ``map_location``
    (``"cpu"``, ``"cuda"``, a `torch.device`)."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def restore_checkpoint_raw(path: str) -> Any:
    """The tree saved at ``path`` with its tensors on the CPU: no template or
    device needed (an evaluation that wants ``["state"]["policy"]`` alone)."""
    return restore_checkpoint(path, map_location="cpu")


def latest_step_dir(root: str) -> Optional[str]:
    """The ``step_<n>`` entry of ``root`` with the largest ``n`` (None when
    ``root`` is no directory or holds none)."""
    if not os.path.isdir(root):
        return None
    steps = [(int(m.group(1)), d) for d in os.listdir(root) if (m := _STEP.match(d))]
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])
