"""Optimizer / LR-schedule factories (counterpart of `rl4co_tpu/utils/optim.py`,
which builds optax transformations by name), over `torch.optim`.

A schedule is a plain function ``step -> learning rate`` on Python numbers,
step-indexed from 0 as an optax schedule is; pass ``steps_per_epoch`` to
express milestones in epochs. `get_optimizer` returns an `Optimizer`: the
`torch.optim` instance, the optional clipping by global norm before it and the
schedule, behind ``zero_grad / step / state_dict / load_state_dict``.

Where the two libraries differ, the port keeps optax's arithmetic or says so:

- **clipping**: optax scales the gradients by ``c / max(norm, c)``
  (`rl4co_tpu/utils/optim.py:45-46`); `torch.nn.utils.clip_grad_norm_` by
  ``c / (norm + 1e-6)``. `Optimizer.step` writes optax's form out.
- **adam**: both compute ``m_hat / (sqrt(v_hat) + eps)`` with eps 1e-8 outside
  the root and the same bias corrections; held to optax in the tests.
- **adamw**: `OptaxAdamW`, optax's arithmetic in its order (optax decays
  inside the update, after the bias-corrected moments; torch before them);
  optax's default weight decay, 1e-4 (torch's is 1e-2).
- **rmsprop**: optax decays the second moment at 0.9, torch at 0.99; the
  default here is 0.9, under optax's name ``decay``. optax adds eps inside
  the root, torch outside: updates differ where ``v`` is of eps's size.
- **adagrad**: optax starts its accumulator at 0.1 with eps 1e-7; those are
  the defaults here. The same remark on eps applies.
- **lamb**, **lion**, **adafactor**: `torch.optim` has no class for the first
  two, and its Adafactor is another update rule than optax's; `OptaxLamb`,
  `OptaxLion` and `OptaxAdafactor` compute optax's updates, with its
  defaults (Adafactor: the second moments of a matrix whose two largest
  dimensions reach 128 factored into rows and columns, the update clipped to
  block RMS 1 and scaled by the parameter's RMS).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def _rmsprop(params, lr, decay: float = 0.9, eps: float = 1e-8, **kwargs):
    return torch.optim.RMSprop(params, lr=lr, alpha=decay, eps=eps, **kwargs)


def _adagrad(params, lr, initial_accumulator_value: float = 0.1, eps: float = 1e-7,
             **kwargs):
    return torch.optim.Adagrad(params, lr=lr, eps=eps,
                               initial_accumulator_value=initial_accumulator_value,
                               **kwargs)


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.adamw`` operation for operation, in f32: the moments
    ``(1 - b) g + b m``, the bias corrections ``1 - b ** count`` taken in f32,
    ``m_hat / (sqrt(v_hat) + eps)``, then ``+ weight_decay · p``, times ``-lr``,
    added to ``p``. `torch.optim.AdamW` decays ``p`` before its step and folds
    the corrections into the step size in f64, which moves the last bits
    (8 ulps of a parameter after three steps)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["count"] += 1
                st["mu"] = g * (1 - b1) + st["mu"] * b1
                st["nu"] = (g * g) * (1 - b2) + st["nu"] * b2
                count = torch.tensor(float(st["count"]), dtype=torch.float32)
                bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
                bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
                u = (st["mu"] / bc1.to(p.device)) / ((st["nu"] / bc2.to(p.device)).sqrt()
                                                      + group["eps"])
                u = (u + p * group["weight_decay"]) * (-group["lr"])
                p.add_(u)


def _adamw(params, lr, weight_decay: float = 1e-4, **kwargs):
    return OptaxAdamW(params, lr=lr, weight_decay=weight_decay, **kwargs)


def _bias_correction(decay: float, count: int, device) -> torch.Tensor:
    """optax's ``1 - decay ** count`` in f32."""
    return (1 - torch.tensor(decay, dtype=torch.float32)
            ** torch.tensor(float(count), dtype=torch.float32)).to(device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x.square().sum().sqrt()


class OptaxLamb(torch.optim.Optimizer):
    """``optax.lamb``: Adam's bias-corrected step ``m_hat / (sqrt(v_hat) +
    eps)``, plus ``weight_decay · p``, scaled by the trust ratio ``|p| / |u|``
    (1 where either norm is 0), times ``-lr``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                g = p.grad
                st["count"] += 1
                st["mu"] = g * (1 - b1) + st["mu"] * b1
                st["nu"] = (g * g) * (1 - b2) + st["nu"] * b2
                u = ((st["mu"] / _bias_correction(b1, st["count"], p.device))
                     / ((st["nu"] / _bias_correction(b2, st["count"], p.device)).sqrt()
                        + group["eps"]))
                u = u + p * group["weight_decay"]
                p_norm, u_norm = _norm(p), _norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
                p.add_(u * ratio * (-group["lr"]))


class OptaxLion(torch.optim.Optimizer):
    """``optax.lion``: ``sign((1 - b1) g + b1 m)``, plus ``weight_decay · p``,
    times ``-lr``; then ``m ← (1 - b2) g + b2 m``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                g = p.grad
                u = torch.sign(g * (1 - b1) + st["mu"] * b1)
                st["mu"] = g * (1 - b2) + st["mu"] * b2
                p.add_((u + p * group["weight_decay"]) * (-group["lr"]))


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest dimensions ``(d1, d0)`` if the smaller
    of them reaches ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class OptaxAdafactor(torch.optim.Optimizer):
    """``optax.adafactor`` with a learning rate and its defaults: the update
    ``g / sqrt(v)`` with ``v`` decayed at ``1 - (t + 1) ** -decay_rate``,
    factored into row and column means for a matrix of at least
    ``min_dim_size_to_factor`` in its two largest dimensions; clipped to
    block RMS ``clipping_threshold``; times ``lr`` and the parameter's RMS
    (at least 1e-3); negated."""

    def __init__(self, params, lr: float = 1e-3, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 eps: float = 1e-30):
        super().__init__(params, dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                                      decay_rate=decay_rate,
                                      clipping_threshold=clipping_threshold, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
                if not st:
                    st["count"] = 0
                    if dims is None:
                        st["v"] = torch.zeros_like(p)
                    else:
                        st["v_row"] = torch.zeros_like(p).mean(dim=dims[1])
                        st["v_col"] = torch.zeros_like(p).mean(dim=dims[0])
                t = torch.tensor(float(st["count"] + 1), dtype=torch.float32)
                decay = (1.0 - t ** (-group["decay_rate"])).to(p.device)
                g = p.grad
                grad_sqr = g * g + group["eps"]
                if dims is None:
                    st["v"] = decay * st["v"] + (1.0 - decay) * grad_sqr
                    u = g * st["v"] ** -0.5
                else:
                    d1, d0 = dims
                    st["v_row"] = decay * st["v_row"] + (1.0 - decay) * grad_sqr.mean(dim=d0)
                    st["v_col"] = decay * st["v_col"] + (1.0 - decay) * grad_sqr.mean(dim=d1)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
                    row_factor = (st["v_row"] / row_col_mean) ** -0.5
                    col_factor = st["v_col"] ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                st["count"] += 1
                u = u / torch.clamp(u.square().mean().sqrt() / group["clipping_threshold"],
                                    min=1.0)
                u = u * group["lr"]
                rms = p.square().mean().sqrt()
                u = u * torch.where(rms <= 1e-3, 1e-3, rms)
                p.add_(u * -1)


OPTIMIZER_REGISTRY = {
    "adam": torch.optim.Adam,
    "adamw": _adamw,
    "sgd": torch.optim.SGD,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
    "lamb": OptaxLamb,
    "lion": OptaxLion,
    "adafactor": OptaxAdafactor,
}


class Optimizer:
    """Clip by global norm, then the `torch.optim` step at the schedule's
    learning rate for this step index; without a schedule each parameter
    group keeps its own learning rate (A2C's actor and critic, as
    `optax.multi_transform` gives each branch its own)."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Optional[Schedule],
                 grad_clip: Optional[float] = None):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip if grad_clip is not None and grad_clip > 0 else None
        self.count = 0                    # steps taken: the schedule's index
        # global gradient norm of the last step before clipping (None without clipping)
        self.grad_norm: Optional[torch.Tensor] = None

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for group in self.inner.param_groups for p in group["params"]
                 if p.grad is not None]
        if self.grad_clip is not None and grads:
            self.grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = self.grad_clip / self.grad_norm.clamp(min=self.grad_clip)
            for g in grads:
                g.mul_(scale)
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.inner.param_groups:
                group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def get_optimizer(
    params: Iterable[torch.nn.Parameter],
    name: str = "adam",
    learning_rate: Union[float, Schedule] = 1e-4,
    grad_clip: Optional[float] = None,
    **kwargs,
) -> Optimizer:
    """By-name optimizer factory over ``params``.

    ``learning_rate`` may be a float or a schedule (see `get_lr_schedule`).
    ``grad_clip`` puts clipping by global norm before the update.
    """
    key = name.lower().replace("_", "")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(
            f"Unknown optimizer '{name}'. Available: {sorted(OPTIMIZER_REGISTRY)}")
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    inner = OPTIMIZER_REGISTRY[key](list(params), lr=float(schedule(0)), **kwargs)
    return Optimizer(inner, schedule, grad_clip)


def get_lr_schedule(
    name: str = "constant",
    learning_rate: float = 1e-4,
    *,
    milestones: Sequence[int] = (),
    gamma: float = 0.1,
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    min_lr: float = 0.0,
    steps_per_epoch: int = 1,
) -> Schedule:
    """By-name LR schedule factory.

    names: ``constant`` | ``multistep`` (decay ×gamma at each milestone
    epoch) | ``cosine`` | ``exponential`` (×gamma per epoch). Milestones and
    the exponential decay are given in epochs and converted with
    ``steps_per_epoch``. ``warmup_steps > 0`` puts a linear warm-up from 0 in
    front; the schedule behind it then starts counting at its end.
    """
    n = name.lower()
    if n == "constant":
        def sched(step):
            return learning_rate
    elif n in ("multistep", "multisteplr"):
        boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

        def sched(step):
            return learning_rate * gamma ** sum(step >= b for b in boundaries)
    elif n in ("cosine", "cosineannealinglr"):
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        if total_steps <= 0:
            raise ValueError(f"cosine schedule requires positive total_steps, got {total_steps}")
        alpha = min_lr / max(learning_rate, 1e-12)

        def sched(step):
            cosine = 0.5 * (1 + math.cos(math.pi * min(step, total_steps) / total_steps))
            return learning_rate * ((1 - alpha) * cosine + alpha)
    elif n in ("exponential", "exponentiallr"):
        def sched(step):
            return learning_rate * gamma ** max(step // steps_per_epoch, 0)
    else:
        raise ValueError(f"Unknown schedule '{name}'")
    if warmup_steps <= 0:
        return sched

    def with_warmup(step):
        if step < warmup_steps:
            return learning_rate * step / warmup_steps
        return sched(step - warmup_steps)

    return with_warmup
