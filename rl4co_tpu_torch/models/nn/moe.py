"""Mixture-of-Experts layers (counterpart of `rl4co_tpu/models/nn/moe.py`).

All experts run on all tokens as one batched product and are mixed by the
top-k-sparsified gate weights (dense evaluation, as in the JAX package:
static shapes, no dispatch by expert). The experts' parameters are stacked,
``kernel [E, in, out]`` and ``bias [E, out]`` per layer, as the JAX
package's vmapped experts store them, and used as ``x @ kernel``.

Behaviours of the JAX package kept as they are:

- gating keeps every expert whose logit is at least the k-th largest, so
  ties with the k-th are all kept: with ``w_gate`` at its zero
  initialisation every expert is selected, each with weight 1/E;
- the gating noise is applied only when the JAX module is called with
  ``train=True``, which no caller does (nor does ``w_noise`` exist in its
  parameters): the port has no noisy gating;
- the load-balancing value (`MoE.aux_loss`) is sown there and read by
  nothing; here it is a method, and no loss adds it.

Expert parallelism (`rl4co_tpu_torch.parallel.mesh.shard_params_model_axis`
splits the experts' leading axis over a mesh's ``model`` axis): each model
rank holds ``E / model`` experts and runs them on every token, the gate runs
whole on every rank, and each rank's gate-weighted mix of its own experts is
summed over the model ranks.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rl4co_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model


class StackedDense(nn.Module):
    """``num_experts`` Dense layers in one: ``kernel [E, in, out]``, ``bias [E, out]``."""

    def __init__(self, num_experts: int, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(num_experts, in_dim, out_dim) * in_dim ** -0.5)
        self.bias = nn.Parameter(torch.zeros(num_experts, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [T, in]`` (every expert's input) or ``[E, T, in]`` -> ``[E, T, out]``."""
        return torch.matmul(x, self.kernel) + self.bias[:, None, :]


class ExpertMLP(nn.Module):
    """The experts: Dense layers ``Dense_0 … Dense_n`` with ReLU between
    (the JAX package's callers all use its default activation, ReLU)."""

    def __init__(self, num_experts: int, in_dim: int, output_dim: int,
                 num_neurons: Sequence[int] = ()):
        super().__init__()
        dims = [in_dim, *num_neurons, output_dim]
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            self.add_module(f"Dense_{i}", StackedDense(num_experts, dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [T, in]`` -> every expert's output ``[E, T, out]``."""
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class MoE(nn.Module):
    """Top-k gated MoE (Shazeer et al. 2017) over the last axis of its input:
    ``w_gate [in, E]`` (used as ``x @ w_gate``), zero at initialisation."""

    def __init__(self, in_dim: int, output_dim: int, num_neurons: Sequence[int] = (),
                 num_experts: int = 4, k: int = 2, loss_coef: float = 1e-2):
        super().__init__()
        self.output_dim = output_dim
        self.k = min(k, num_experts)
        self.loss_coef = loss_coef
        self.w_gate = nn.Parameter(torch.zeros(in_dim, num_experts))
        self.experts = ExpertMLP(num_experts, in_dim, output_dim, num_neurons)
        self.tp_mesh = None   # set when the experts are split over a mesh's model axis

    def tp_experts(self) -> list:
        """``(module, parameter name)`` of every expert parameter: what
        expert parallelism splits along the leading axis."""
        return [(layer, name) for layer in self.experts.children()
                for name in ("kernel", "bias")]

    def gates(self, flat: torch.Tensor) -> torch.Tensor:
        """Gate weights ``[T, E]`` of tokens ``flat [T, in]``: a softmax over
        the experts whose logit is at least the k-th largest, 0 elsewhere."""
        logits = flat @ self.w_gate
        threshold = torch.topk(logits, self.k, dim=-1).values[..., -1:]
        return torch.softmax(torch.where(logits >= threshold, logits, -torch.inf), dim=-1)

    def aux_loss(self, gates: torch.Tensor) -> torch.Tensor:
        """The load-balancing value of ``gates [T, E]``: ``loss_coef`` times
        the squared coefficients of variation of importance and load."""
        def cv_sq(v):
            return v.var(unbiased=False) / (v.mean().square() + 1e-10)

        load = (gates > 0).sum(dim=0).float()
        return self.loss_coef * (cv_sq(gates.sum(dim=0)) + cv_sq(load))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        gates = self.gates(flat)
        mesh = self.tp_mesh
        if mesh is None:
            mixed = torch.einsum("te,etd->td", gates, self.experts(flat))
        else:   # this rank's experts on every token, their mix summed over the ranks
            local = self.experts.Dense_0.kernel.shape[0]
            lo = mesh.model_rank * local
            gates = copy_to_model(gates, mesh)[:, lo:lo + local]
            mixed = reduce_from_model(torch.einsum(
                "te,etd->td", gates, self.experts(copy_to_model(flat, mesh))), mesh)
        return mixed.reshape(*x.shape[:-1], self.output_dim)
