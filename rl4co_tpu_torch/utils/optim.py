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
  two, and its Adafactor is another update rule than optax's; they raise
  `NotImplementedError` until a test can hold them to optax (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

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


OPTIMIZER_REGISTRY = {
    "adam": torch.optim.Adam,
    "adamw": _adamw,
    "sgd": torch.optim.SGD,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
}
NOT_PORTED = ("lamb", "lion", "adafactor")


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
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer '{name}' is not ported yet (ROADMAP.md, Queue A)")
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
