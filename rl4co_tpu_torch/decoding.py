"""Decoding strategies as static specs + plain functions (counterpart of
`rl4co_tpu/decoding.py`).

`process_logits` keeps the pipeline order exactly: tanh clipping →
feasibility mask → temperature → top-k filter → top-p filter → log-softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.utils.dtype import torch_dtype

MASK_VALUE = -1e9


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decoding configuration.

    kind: 'greedy' | 'sampling' | 'evaluate' (replay given actions) |
        'beam_search' (``beam_width`` beams, default ``env.get_num_starts()``).
    multistart: POMO-style forced diverse first actions (+ `num_starts`).
    num_samples: i.i.d. sampling repeats (mutually exclusive with multistart).
    select_best: reduce the starts/samples/beams axis by max reward at the end.
    compute_dtype: None (f32) or a floating dtype's name, e.g. ``"bfloat16"``:
        the rollout runs on the parameters rounded through it
        (`rl4co_tpu_torch/utils/dtype.py`); logits, softmax and sampling stay f32.
    """

    kind: str = "sampling"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    tanh_clipping: float = 0.0
    mask_logits: bool = True
    multistart: bool = False
    num_starts: int = 0
    num_samples: int = 0
    select_best: bool = False
    beam_width: int = 0
    compute_dtype: Optional[str] = None
    # rematerialize the decode step in the backward pass: not ported, True raises
    remat: bool = False

    def __post_init__(self):
        if self.kind not in ("greedy", "sampling", "evaluate", "beam_search"):
            raise ValueError(f"unknown decode kind {self.kind!r}")
        if self.multistart and self.num_samples > 1:
            raise ValueError("multistart and num_samples > 1 are mutually exclusive")
        if self.remat:
            raise NotImplementedError(
                "remat=True: rematerialising the decode step is not ported (ROADMAP.md)")
        if self.compute_dtype is not None:
            torch_dtype(self.compute_dtype)  # raises on a name that is no floating dtype


def get_decoding_strategy(name: str, **kwargs) -> DecodeSpec:
    """Name-based factory: the JAX package's name table."""
    table = {
        "greedy": dict(kind="greedy"),
        "sampling": dict(kind="sampling"),
        "multistart_greedy": dict(kind="greedy", multistart=True),
        "multistart_sampling": dict(kind="sampling", multistart=True),
        "evaluate": dict(kind="evaluate"),
        "beam_search": dict(kind="beam_search", select_best=True),
    }
    if name not in table:
        raise ValueError(f"Unknown decode type {name}. Available: {sorted(table)}")
    return DecodeSpec(**{**table[name], **kwargs})


def modify_logits_for_top_k_filtering(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only top-k logits."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def modify_logits_for_top_p_filtering(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, stable=True).values  # ascending
    cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    sorted_remove = cum_probs <= (1.0 - top_p)
    # map the per-rank removal decision back to original positions
    order = torch.argsort(logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    remove = torch.gather(sorted_remove, -1, ranks)
    return torch.where(remove, -torch.inf, logits)


def process_logits(
    logits: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    top_p: float = 0.0,
    top_k: int = 0,
    tanh_clipping: float = 0.0,
    mask_logits: bool = True,
) -> torch.Tensor:
    """Logits → log-probabilities."""
    if tanh_clipping > 0:
        logits = torch.tanh(logits) * tanh_clipping
    if mask_logits:
        if mask is None:
            raise ValueError("mask_logits=True needs a mask")
        logits = torch.where(mask, logits, MASK_VALUE)
    logits = logits / temperature
    if top_k > 0:
        top_k = min(top_k, logits.shape[-1])
        logits = modify_logits_for_top_k_filtering(logits, top_k)
    if top_p > 0:
        logits = modify_logits_for_top_p_filtering(logits, top_p)
    return torch.log_softmax(logits, dim=-1)


def process_logits_spec(logits: torch.Tensor, mask: torch.Tensor, spec: DecodeSpec) -> torch.Tensor:
    return process_logits(
        logits,
        mask,
        temperature=spec.temperature,
        top_p=spec.top_p,
        top_k=spec.top_k,
        tanh_clipping=spec.tanh_clipping,
        mask_logits=spec.mask_logits,
    )


def decode_action(
    logprobs: torch.Tensor,  # [B, A]
    mask: torch.Tensor,      # [B, A]
    spec: DecodeSpec,
    generator: Optional[torch.Generator] = None,
    replay_action: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select one action per row and return (action, its logprob).

    greedy → argmax; sampling → categorical draw from ``generator`` (on the
    tensors' device); evaluate → replay given actions.
    """
    if spec.kind == "greedy":
        action = torch.argmax(logprobs, dim=-1)
    elif spec.kind == "sampling":
        action = torch.multinomial(logprobs.exp(), 1, generator=generator)[:, 0]
        # guard against numerically-impossible draws: fall back to argmax on
        # rows whose draw is masked
        bad = ~torch.gather(mask, -1, action[:, None])[:, 0]
        action = torch.where(bad, torch.argmax(logprobs, dim=-1), action)
    elif spec.kind == "evaluate":
        if replay_action is None:
            raise ValueError("kind='evaluate' needs the actions to replay")
        action = replay_action
    else:
        raise ValueError(spec.kind)
    action = action.long()
    return action, take_along_last(logprobs, action)


def take_along_last(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[b, idx[b]]`` as a one-hot reduction.

    Keeps the JAX package's out-of-range semantics, which differ from
    `torch.gather` (it raises): an out-of-range or sentinel index (e.g. -1
    padding) hits nothing and gives ``0.0``. All in-tree callers pass in-range
    actions; a caller introducing sentinel indices must mask the result itself
    (a 0.0 log-prob is a *probability-1* action — not a safe default).
    """
    pos = torch.arange(values.shape[-1], device=values.device)
    hit = pos == idx[..., None]
    return torch.where(hit, values, 0.0).sum(dim=-1)


def get_log_likelihood(
    logprobs: torch.Tensor,  # [B, T] per-step chosen-action logprobs
    valid_mask: Optional[torch.Tensor] = None,  # [B, T] True where step counted
) -> torch.Tensor:
    """Sum step logprobs over valid steps."""
    if valid_mask is not None:
        logprobs = torch.where(valid_mask, logprobs, 0.0)
    return logprobs.sum(dim=-1)
