"""Single Machine Total Weighted Tardiness Problem environment (counterpart
of `rl4co_tpu/envs/scheduling/smtwtp.py`).

Order ``num_job`` jobs on one machine. Node 0 is a dummy start with zero
features; the episode takes ``num_job`` steps and ends when no job is left.
Reward: minus the total weighted tardiness, the completion times being the
running sum of the process times in the order chosen.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SMTWTPState:
    job_due_time: torch.Tensor      # [B, J+1]
    job_weight: torch.Tensor        # [B, J+1]
    job_process_time: torch.Tensor  # [B, J+1]
    current_job: torch.Tensor       # int64 [B]
    current_time: torch.Tensor      # [B]
    available: torch.Tensor         # bool [B, J+1]
    i: torch.Tensor                 # int64 [B]
    done: torch.Tensor              # bool [B]

    @property
    def current_node(self) -> torch.Tensor:
        return self.current_job


@dataclasses.dataclass(frozen=True)
class SMTWTP(Env):
    name = "smtwtp"
    num_job: int = 10
    min_time_span: float = 0.0
    max_time_span: Optional[float] = None  # default num_job / 2
    min_job_weight: float = 0.0
    max_job_weight: float = 1.0
    min_process_time: float = 0.0
    max_process_time: float = 1.0

    @property
    def _max_time_span(self) -> float:
        return self.max_time_span if self.max_time_span is not None else self.num_job / 2

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Due times, weights and process times uniform in their ranges
        from ``generator`` (its own stream, not `jax.random`'s); job 0's
        are zero."""
        device = resolve_device(device)
        shape = (batch_size, self.num_job + 1)

        def uniform(lo, hi):
            u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return (lo + (hi - lo) * u).index_fill(1, torch.tensor([0], device=device), 0.0)

        return {"job_due_time": uniform(self.min_time_span, self._max_time_span),
                "job_weight": uniform(self.min_job_weight, self.max_job_weight),
                "job_process_time": uniform(self.min_process_time, self.max_process_time)}

    def reset(self, instances: Instance) -> SMTWTPState:
        due = instances["job_due_time"]
        b, dev = due.shape[0], due.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        available = torch.ones((b, self.num_job + 1), dtype=torch.bool, device=dev)
        available[:, 0] = False
        return SMTWTPState(
            job_due_time=due,
            job_weight=instances["job_weight"],
            job_process_time=instances["job_process_time"],
            current_job=zeros,
            current_time=torch.zeros((b,), dtype=torch.float32, device=dev),
            available=available,
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: SMTWTPState, action: torch.Tensor) -> SMTWTPState:
        action = action.long()
        available = state.available.scatter(1, action[:, None], False)
        current_time = state.current_time + torch.gather(
            state.job_process_time, 1, action[:, None])[:, 0]
        return freeze_done(dataclasses.replace(
            state, current_job=action, current_time=current_time, available=available,
            i=state.i + 1, done=~available.any(dim=-1)), state)

    def action_mask(self, state: SMTWTPState) -> torch.Tensor:
        pad = torch.zeros_like(state.available)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, state.available)

    def reward(self, state: SMTWTPState, actions: torch.Tensor) -> torch.Tensor:
        acts = actions[:, : self.num_job].long()
        completion = torch.cumsum(torch.gather(state.job_process_time, 1, acts), dim=-1)
        due = torch.gather(state.job_due_time, 1, acts)
        weight = torch.gather(state.job_weight, 1, acts)
        return -(weight * (completion - due).clamp(min=0.0)).sum(dim=-1)

    @property
    def num_actions(self) -> int:
        return self.num_job + 1

    @property
    def max_steps(self) -> int:
        return self.num_job

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.num_job]
        if not (np.sort(actions, axis=-1) == np.arange(1, self.num_job + 1)).all():
            raise AssertionError("Each job must be scheduled exactly once")

