"""Decoding strategies as static specs + plain functions (counterpart of
`rl4co_tpu/decoding.py`).

`process_logits` keeps the pipeline order exactly: tanh clipping →
feasibility mask → temperature → top-k filter → top-p filter → log-softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.parallel.mesh import uniform_rows
from rl4co_tpu_torch.utils.dtype import torch_dtype

MASK_VALUE = -1e9

# XLA's f32 tanh on the CPU (`EmitFastTanh` of its LLVM back end), which the
# JAX package's tanh clipping runs: the input clamped to +-XLA_TANH_CLAMP (the
# bound it takes with fused multiply-adds), a rational function of degree
# 13/6 evaluated by Horner's rule with fused multiply-adds, inputs below
# 4e-4 passed through. Past about |x| = 6 the clipped logits lie within a few
# ulps of +-tanh_clipping, and there its rounding, not the logits, decides
# which of two actions a greedy step takes; from the clamp on, it is exactly
# +-1 and ties go to the lower index.
XLA_TANH_CLAMP = 7.99881172180175781
_TANH_NUMERATOR = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
                   5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
                   4.89352455891786e-03)
_TANH_DENOMINATOR = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
                     4.89352518554385e-03)
# device -> the coefficients as 0-dim f32 tensors on it (an elementwise op on
# the card takes a tensor operand from there only); built once per device
_TANH_COEFFICIENTS: dict = {}


def _coefficients(device: torch.device):
    """Per polynomial: its leading coefficient rounded to f32 (a Python
    float) and the others as 0-dim f32 tensors on ``device``."""
    if device not in _TANH_COEFFICIENTS:
        _TANH_COEFFICIENTS[device] = tuple(
            (torch.tensor(coeffs[0], dtype=torch.float32).item(),
             [torch.tensor(v, dtype=torch.float32, device=device) for v in coeffs[1:]])
            for coeffs in (_TANH_NUMERATOR, _TANH_DENOMINATOR))
    return _TANH_COEFFICIENTS[device]


def _horner(x2: torch.Tensor, coeffs) -> torch.Tensor:
    """The polynomial ``coeffs`` (`_coefficients`) at ``x2`` (f32 values held
    in f64) by Horner's rule with f32 fused multiply-adds, one launch per
    step: the product of two f32 is exact in f64, and the sum is rounded
    once, to f32, as it is stored."""
    lead, rest = coeffs
    out = torch.empty(x2.shape, dtype=torch.float32, device=x2.device)
    torch.add(rest[0], x2, alpha=lead, out=out)
    for c in rest[1:]:
        torch.addcmul(c, x2, out, out=out)
    return out


def _xla_tanh_values(x: torch.Tensor) -> torch.Tensor:
    numerator, denominator = _coefficients(x.device)
    xc = x.clamp(-XLA_TANH_CLAMP, XLA_TANH_CLAMP)
    x2 = (xc * xc).double()
    y = (xc * _horner(x2, numerator)) / _horner(x2, denominator)
    return torch.where(x.abs() < 4e-4, x, y)


class _XlaTanh(torch.autograd.Function):
    """Forward: XLA's f32 tanh; backward: JAX's rule for it, ``(g + g·y)(1 - y)``."""

    @staticmethod
    def forward(ctx, x):
        y = _xla_tanh_values(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return (grad + grad * y) * (1 - y)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 ``tanh`` to the bit as the JAX package computes it on the CPU
    (`torch.tanh` differs in half of all values, by up to 5 ulps, and stays
    below 1 up to 9.01), differentiable as JAX differentiates it."""
    if x.dtype != torch.float32:
        raise TypeError(f"xla_tanh takes float32, got {x.dtype}")
    return _XlaTanh.apply(x)


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
    remat: recompute each decode step's logits in the backward pass instead
        of keeping its intermediates (`torch.utils.checkpoint`, the
        counterpart of ``jax.checkpoint`` on the scan body); the draw stays
        outside the recomputed region.
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
    remat: bool = False

    def __post_init__(self):
        if self.kind not in ("greedy", "sampling", "evaluate", "beam_search"):
            raise ValueError(f"unknown decode kind {self.kind!r}")
        if self.multistart and self.num_samples > 1:
            raise ValueError("multistart and num_samples > 1 are mutually exclusive")
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
        logits = xla_tanh(logits) * tanh_clipping
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
    tensors' device; `categorical_draw`); evaluate → replay given actions.
    """
    if spec.kind == "greedy":
        action = torch.argmax(logprobs, dim=-1)
    elif spec.kind == "sampling":
        action = categorical_draw(logprobs, generator)
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


def categorical_draw(logprobs: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``[rows, A]`` log-probabilities by the inverse of
    the cumulative distribution at a uniform per row (`uniform_rows`: in a
    data-parallel step, the rank's rows of the global draw). An action of
    probability 0 is never drawn."""
    cdf = logprobs.exp().cumsum(dim=-1)
    u = uniform_rows(cdf.shape[0], generator, cdf.device)
    action = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return action.clamp(max=cdf.shape[-1] - 1)


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
