"""Flexible Flow Shop Problem environment (counterpart of
`rl4co_tpu/envs/scheduling/ffsp.py`, MatNet's scheduling env).

Jobs pass through ``num_stage`` stages of ``num_machine`` machines each. At
every decision point the current machine picks an available job or the wait
action (index ``num_job``); the reward is minus the makespan. Run times are
integers, and so is every time the env keeps: schedules and makespans are
exact.

After a choice the env advances to the next decision point: the machine
index walks over the ``num_stage * num_machine`` machines, the clock ticks
at every wrap and every wait shrinks by one per tick, until the current
machine is idle and a job of its stage is waiting for it. The JAX package
runs that walk as a per-instance `lax.while_loop`. Here it is solved in one
pass: since the jobs' stages do not change during the walk, the state after
k moves is known in closed form, and each row takes the first k at which it
is ready (`_advance`), which lands every row where the JAX loop stops it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.utils.device import resolve_device

UNSCHEDULED = -999999


@dataclasses.dataclass
class FFSPState:
    job_duration: torch.Tensor       # int64 [B, J+1, M_total] (the wait job's row is 0)
    time_idx: torch.Tensor           # int64 [B]
    sub_time_idx: torch.Tensor       # int64 [B] in [0, M_total)
    machine_idx: torch.Tensor        # int64 [B]
    stage_idx: torch.Tensor          # int64 [B]
    stage_machine_idx: torch.Tensor  # int64 [B]
    schedule: torch.Tensor           # int64 [B, M_total, J+1] start times
    machine_wait_step: torch.Tensor  # int64 [B, M_total]
    job_location: torch.Tensor       # int64 [B, J+1] the stage each job is at
    job_wait_step: torch.Tensor      # int64 [B, J+1]
    i: torch.Tensor                  # int64 [B]
    done: torch.Tensor               # bool [B]

    @property
    def current_node(self):
        return self.machine_idx


@dataclasses.dataclass(frozen=True)
class FFSP(Env):
    name = "ffsp"
    num_stage: int = 2
    num_machine: int = 3
    num_job: int = 4
    min_time: int = 2
    max_time: int = 10   # exclusive, as `jax.random.randint`'s bound

    @property
    def num_machine_total(self) -> int:
        return self.num_stage * self.num_machine

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Run times ``[B, J, M_total]`` uniform in ``[min_time, max_time)``
        from ``generator`` (its own stream)."""
        device = resolve_device(device)
        run_time = torch.randint(self.min_time, self.max_time,
                                 (batch_size, self.num_job, self.num_machine_total),
                                 generator=generator, device=device)
        return {"run_time": run_time}

    def reset(self, instances: Instance) -> FFSPState:
        run_time = instances["run_time"].long()
        b, dev = run_time.shape[0], run_time.device
        j, m = self.num_job, self.num_machine_total
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return FFSPState(
            job_duration=torch.cat([run_time, run_time.new_zeros((b, 1, m))], dim=1),
            time_idx=zeros,
            sub_time_idx=zeros.clone(),
            machine_idx=zeros.clone(),
            stage_idx=zeros.clone(),
            stage_machine_idx=zeros.clone(),
            schedule=torch.full((b, m, j + 1), UNSCHEDULED, dtype=torch.long, device=dev),
            machine_wait_step=torch.zeros((b, m), dtype=torch.long, device=dev),
            job_location=torch.zeros((b, j + 1), dtype=torch.long, device=dev),
            job_wait_step=torch.zeros((b, j + 1), dtype=torch.long, device=dev),
            i=zeros.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def _job_available(self, state: FFSPState) -> torch.Tensor:
        loc = state.job_location[:, : self.num_job]
        wait = state.job_wait_step[:, : self.num_job]
        return (loc == state.stage_idx[:, None]) & (wait == 0)

    def _advance(self, state: FFSPState, rows: torch.Tensor) -> FFSPState:
        """Move each of ``rows`` (bool [B]) to its next decision point.

        After k moves from machine s0 the machine is ``(s0 + k) % M``, the
        clock has ticked ``(s0 + k) // M`` times and every wait has shrunk by
        that many (floored at 0). Row b stops at the least k where its machine
        is idle and a job of the machine's stage has no wait left; k = 0 when
        it is ready already. Within ``M * (longest wait + 2)`` moves every
        wait is gone and every stage is visited, so an unfinished row stops."""
        m = self.num_machine_total
        longest = int(torch.maximum(state.machine_wait_step.max(),
                                    state.job_wait_step.max()).item())
        k = torch.arange(m * (max(longest, 0) + 2), device=state.time_idx.device)
        pos = state.sub_time_idx[:, None] + k[None, :]              # [B, K]
        sub, ticks = pos % m, pos // m
        machine_idle = torch.gather(state.machine_wait_step, 1, sub) <= ticks
        stage = sub // self.num_machine                               # [B, K]
        loc = state.job_location[:, : self.num_job]
        wait = state.job_wait_step[:, : self.num_job]
        job_ready = ((loc[:, None, :] == stage[:, :, None])
                     & (wait[:, None, :] <= ticks[:, :, None])).any(dim=-1)
        ready = machine_idle & job_ready
        first = torch.argmax(ready.to(torch.uint8), dim=1)           # the least k
        if not bool(ready.any(dim=1)[rows].all()):
            raise RuntimeError("FFSP: an unfinished row found no decision point")
        k_row = torch.where(rows, first, torch.zeros_like(first))
        new_pos = state.sub_time_idx + k_row
        new_sub, tick = new_pos % m, new_pos // m
        return dataclasses.replace(
            state,
            time_idx=state.time_idx + tick,
            sub_time_idx=new_sub,
            machine_idx=new_sub,  # the identity machine table
            stage_idx=new_sub // self.num_machine,
            stage_machine_idx=new_sub % self.num_machine,
            machine_wait_step=(state.machine_wait_step - tick[:, None]).clamp(min=0),
            job_wait_step=(state.job_wait_step - tick[:, None]).clamp(min=0),
        )

    def step(self, state: FFSPState, action: torch.Tensor) -> FFSPState:
        action = action.long()
        b = action.shape[0]
        rows = torch.arange(b, device=action.device)
        job_location = state.job_location.clone()
        job_location[rows, action] += 1
        schedule = state.schedule.clone()
        schedule[rows, state.machine_idx, action] = state.time_idx
        dur = state.job_duration[rows, action, state.machine_idx]
        machine_wait = state.machine_wait_step.clone()
        machine_wait[rows, state.machine_idx] = dur
        job_wait = state.job_wait_step.clone()
        job_wait[rows, action] = dur
        done = (job_location[:, : self.num_job] == self.num_stage).all(dim=-1)
        new = dataclasses.replace(state, job_location=job_location, schedule=schedule,
                                  machine_wait_step=machine_wait, job_wait_step=job_wait,
                                  i=state.i + 1, done=done)
        new = self._advance(new, ~done & ~state.done)
        # rows done before this step keep their state
        return _where_state(state.done, state, new)

    def action_mask(self, state: FFSPState) -> torch.Tensor:
        """The jobs available to the current machine, then the wait action,
        allowed while a job is in an earlier stage or waits in this one."""
        loc = state.job_location[:, : self.num_job]
        wait_time = state.job_wait_step[:, : self.num_job]
        in_stage = loc == state.stage_idx[:, None]
        job_in_prev = (loc < state.stage_idx[:, None]).any(dim=-1)
        job_waiting = (in_stage & (wait_time > 0)).any(dim=-1)
        wait_allowed = job_in_prev | job_waiting | state.done
        mask = torch.cat([self._job_available(state), wait_allowed[:, None]], dim=-1)
        pad = torch.zeros_like(mask)
        pad[:, self.num_job] = True
        return torch.where(state.done[:, None], pad, mask)

    def reward(self, state: FFSPState, actions: torch.Tensor) -> torch.Tensor:
        """Minus the makespan: the latest end of a real job on any machine."""
        end = state.schedule + state.job_duration.transpose(1, 2)
        return -end[:, :, : self.num_job].amax(dim=(1, 2)).float()

    @property
    def num_actions(self) -> int:
        return self.num_job + 1  # the wait action last

    @property
    def max_steps(self) -> int:
        # J*S scheduling decisions plus room for wait actions
        return self.num_job * self.num_stage * 3

    def check_solution_validity(self, instance, actions) -> None:
        pass  # the schedule is consistent by construction, as in the JAX package


def _where_state(keep: torch.Tensor, old, new):
    """Field by field, ``old`` on the rows of ``keep`` (bool [B]), else ``new``."""
    out = {}
    for f in dataclasses.fields(old):
        o, n = getattr(old, f.name), getattr(new, f.name)
        out[f.name] = torch.where(keep.reshape(-1, *([1] * (o.ndim - 1))), o, n)
    return type(old)(**out)
