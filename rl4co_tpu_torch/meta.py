"""Reptile meta-learning across task distributions (counterpart of
`rl4co_tpu/meta.py`).

Per epoch: sample a task (env keyword arguments such as the problem size),
train a fresh algorithm for the task from the current meta-weights, then move
the meta-weights toward the result: θ_meta ← θ_meta + β (θ_task − θ_meta),
with β decayed linearly over the epochs.

The tasks are drawn from ``random.Random(config.seed)`` as in the JAX
package, so both draw the same sequence. Each task's algorithm is built
anew by ``make_algo`` (fresh optimiser state, and baseline state from its
own initial weights, as the JAX package re-initialises the algorithm per
task) and then takes the meta-weights.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, Sequence

import torch


@dataclasses.dataclass
class ReptileConfig:
    meta_beta: float = 1.0          # initial outer step size
    beta_decay: bool = True         # linear decay to 0 over the epochs
    tasks: Sequence[dict] = (       # the task space: env keyword arguments
        {"num_loc": 20}, {"num_loc": 50}, {"num_loc": 100},
    )
    seed: int = 0


class Reptile:
    """The meta-loop around ``make_algo(task) -> algorithm`` (e.g. POMO on
    TSP-n on some device): ``run`` trains each task's algorithm for
    ``steps_per_task`` train steps from the meta-weights."""

    def __init__(self, make_algo: Callable[[dict], object], config: ReptileConfig):
        self.make_algo = make_algo
        self.config = config
        self._rng = random.Random(config.seed)

    def sample_task(self) -> dict:
        return self._rng.choice(list(self.config.tasks))

    def beta_at(self, epoch: int, total_epochs: int) -> float:
        if not self.config.beta_decay:
            return self.config.meta_beta
        return self.config.meta_beta * (1.0 - epoch / max(total_epochs, 1))

    def outer_update(self, meta_params: Dict[str, torch.Tensor],
                     task_params: Dict[str, torch.Tensor], beta: float) -> dict:
        """θ_meta + β (θ_task − θ_meta), parameter by parameter."""
        return {k: m + beta * (task_params[k] - m) for k, m in meta_params.items()}

    def run(self, epochs: int, steps_per_task: int, batch_size: int, seed: int = 0,
            logger=print) -> Dict[str, torch.Tensor]:
        """The meta-weights after ``epochs`` tasks, by parameter name; the
        meta-weights start as the first sampled task's initial policy.
        Epoch ``e`` trains from the random stream ``(seed, e)``."""
        algo = self.make_algo(self.sample_task())
        meta = _parameters(algo.policy)
        for epoch in range(epochs):
            task = self.sample_task()
            algo = self.make_algo(task)
            with torch.no_grad():
                for name, p in algo.policy.named_parameters():
                    p.copy_(meta[name])
            algo.reseed(seed, epoch)
            metrics = {}
            for _ in range(steps_per_task):
                metrics = algo.train_step(batch_size)
            beta = self.beta_at(epoch, epochs)
            meta = self.outer_update(meta, _parameters(algo.policy), beta)
            loss = metrics.get("loss")
            logger({"epoch": epoch, "task": task, "beta": round(beta, 4),
                    "loss": float("nan") if loss is None else float(loss)})
        return meta


def _parameters(policy: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {name: p.detach().clone() for name, p in policy.named_parameters()}
