"""Positional embeddings of the improvement models (counterpart of
`rl4co_tpu/models/nn/pos_embeddings.py`).

A pattern depends only on (N, D): it is computed once with numpy (float64,
cast to float32 at the end, as the JAX package computes it) and indexed by
the solution's visit order ``visited_time``. The embeddings have no
parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


def absolute_pattern(n_position: int, emb_dim: int) -> np.ndarray:
    """The original transformer's sinusoidal table; row 0 stays raw."""
    pattern = np.array(
        [
            [pos / np.power(10000, 2 * (j // 2) / emb_dim) for j in range(emb_dim)]
            for pos in range(1, n_position + 1)
        ],
        dtype=np.float32,
    )
    pattern[1:, 0::2] = np.sin(pattern[1:, 0::2])
    pattern[1:, 1::2] = np.cos(pattern[1:, 1::2])
    return pattern


def cyclic_pattern(n_position: int, emb_dim: int) -> np.ndarray:
    """The cyclic positional encoding of Ma et al. 2021."""

    def basesin(x, T, fai=0.0):
        return np.sin(2 * np.pi / T * np.abs(np.mod(x, 2 * T) - T) + fai)

    def basecos(x, T, fai=0.0):
        return np.cos(2 * np.pi / T * np.abs(np.mod(x, 2 * T) - T) + fai)

    td_set = np.linspace(
        np.power(n_position, 1 / (emb_dim // 2)), n_position, emb_dim // 2, dtype="int"
    )
    x = np.zeros((n_position, emb_dim))
    for i in range(emb_dim):
        td = (
            td_set[i // 3 * 3 + 1]
            if (i // 3 * 3 + 1) < (emb_dim // 2)
            else td_set[-1]
        )
        fai = (
            0.0
            if i <= (emb_dim // 2)
            else 2 * np.pi * ((-i + (emb_dim // 2)) / (emb_dim // 2))
        )
        longer = np.arange(0, np.ceil(n_position / td) * td, 0.01)
        idx = np.linspace(0, len(longer), n_position, dtype="int", endpoint=False)
        if i % 2 == 1:
            x[:, i] = basecos(longer, td, fai)[idx]
        else:
            x[:, i] = basesin(longer, td, fai)[idx]
    return x.astype(np.float32)


PATTERNS = {"APE": absolute_pattern, "CPE": cyclic_pattern}


@functools.lru_cache(maxsize=None)
def _pattern_numpy(pos_type: str, n: int, d: int) -> np.ndarray:
    return PATTERNS[pos_type](n, d)


class PositionalEmbedding(nn.Module):
    """``pattern[visited_time % N]``: ``[B, N] -> [B, N, D]``. The pattern is
    kept per device once made."""

    def __init__(self, pos_type: str, embed_dim: int):
        super().__init__()
        if pos_type not in PATTERNS:
            raise ValueError(f"Unknown pos embedding {pos_type}")
        self.pos_type, self.embed_dim = pos_type, embed_dim
        self._tables: dict = {}

    def forward(self, state) -> torch.Tensor:
        vt = state.visited_time
        n = vt.shape[-1]
        key = (n, vt.device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                _pattern_numpy(self.pos_type, n, self.embed_dim)).to(vt.device)
        return self._tables[key][vt % n]


class AbsolutePositionalEmbedding(PositionalEmbedding):
    """The absolute (sinusoidal) pattern."""

    def __init__(self, embed_dim: int):
        super().__init__("APE", embed_dim)


class CyclicPositionalEmbedding(PositionalEmbedding):
    """The cyclic pattern."""

    def __init__(self, embed_dim: int):
        super().__init__("CPE", embed_dim)


POS_EMBEDDING_REGISTRY = {
    "APE": AbsolutePositionalEmbedding,
    "CPE": CyclicPositionalEmbedding,
}


def pos_init_embedding(pos_type: str, embed_dim: int) -> PositionalEmbedding:
    """``"APE"`` (absolute) or ``"CPE"`` (cyclic)."""
    cls = POS_EMBEDDING_REGISTRY.get(pos_type)
    if cls is None:
        raise ValueError(f"Unknown pos embedding {pos_type}")
    return cls(embed_dim)
