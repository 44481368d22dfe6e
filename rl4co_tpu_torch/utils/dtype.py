"""Mixed precision (counterpart of `rl4co_tpu/utils/dtype.py`).

``DecodeSpec.compute_dtype="bfloat16"`` makes the JAX package cast every
floating parameter to bf16 before the forward pass. A Flax ``Dense`` with
f32 inputs and a bf16 kernel promotes to **f32**, and so do the norms'
scale and bias, the MoE gate and the pointer's output projection (each
meets an f32 activation): the arithmetic is f32 on bf16-rounded weights.
`rounded_parameters` gives exactly that: f32 copies of the f32 masters
rounded through the compute dtype, differentiable, so that a rollout run on
them (`torch.func.functional_call`) sends its gradients back to the masters.
A cast that rounds passes the gradient through, rounded once to the compute
dtype on its way back; the JAX package rounds each use's cotangent and sums
them in bf16, so the two agree to bf16 rounding, not to f32's.

Where two bf16 operands meet in the JAX package it computes in bf16: a
module that holds such a site rounds its parameter for it in its own
``round_parameters(dtype)`` (`TSPContext`: ``W_placeholder - 1.0``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """The floating torch dtype called ``name`` (``"bfloat16"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype={name!r} is not a floating torch dtype")
    return dtype


def round_through(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to its own dtype; differentiable."""
    return x.to(dtype).to(x.dtype)


def rounded_parameters(module: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every floating parameter of ``module`` by its qualified name, rounded
    through ``dtype`` (or as its module's ``round_parameters`` rounds it),
    still recording the graph back to the parameter."""
    out = {}
    for prefix, mod in module.named_modules():
        own = mod.round_parameters(dtype) if hasattr(mod, "round_parameters") else {}
        for name, p in mod.named_parameters(recurse=False):
            if p.is_floating_point():
                key = f"{prefix}.{name}" if prefix else name
                out[key] = own[name] if name in own else round_through(p, dtype)
    return out
