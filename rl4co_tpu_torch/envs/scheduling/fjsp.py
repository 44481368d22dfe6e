"""Flexible Job-Shop Scheduling (FJSP) and Job-Shop Scheduling (JSSP)
environments (counterpart of `rl4co_tpu/envs/scheduling/fjsp.py`).

FJSP's action space is ``1 + num_jobs * num_mas``: index 0 is the no-op
(the padding action once done), index ``1 + j * num_mas + m`` starts job j's
next operation on machine m. JSSP's is ``1 + num_jobs``: each operation has
one machine, so an action names a job. After a choice the clock moves to
the next machine-idle event until some action is feasible (the JAX
package's per-instance `lax.while_loop`; here a loop over the batch that
moves only the rows still waiting, so every row stops where JAX stops it).
Times are integers held in f32, so every state is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.scheduling.ffsp import _where_state
from rl4co_tpu_torch.utils.device import resolve_device

INIT_FINISH = 9999.0


@dataclasses.dataclass
class FJSPState:
    proc_times: torch.Tensor       # [B, M, O] processing times left (0: not eligible or done)
    orig_proc_times: torch.Tensor  # [B, M, O] as generated
    pad_mask: torch.Tensor         # bool [B, O] True = padding operation
    start_op: torch.Tensor         # int64 [B, J]
    end_op: torch.Tensor           # int64 [B, J]
    job_ops_adj: torch.Tensor      # [B, J, O] 1.0 where the operation is the job's
    ops_job_map: torch.Tensor      # int64 [B, O]
    ops_seq_order: torch.Tensor    # int64 [B, O]
    start_times: torch.Tensor      # [B, O]
    finish_times: torch.Tensor     # [B, O] INIT_FINISH while unscheduled
    ma_of_op: torch.Tensor         # int64 [B, O] (-1 unassigned)
    busy_until: torch.Tensor       # [B, M]
    next_op: torch.Tensor          # int64 [B, J]
    op_scheduled: torch.Tensor     # bool [B, O]
    job_in_process: torch.Tensor   # bool [B, J]
    job_done: torch.Tensor         # bool [B, J]
    time: torch.Tensor             # [B]
    i: torch.Tensor                # int64 [B]
    done: torch.Tensor             # bool [B]

    @property
    def current_node(self):
        return torch.zeros_like(self.i)


def _set(x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``x[b, idx[b]] = value[b]`` on a copy."""
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device).expand(x.shape[0])
    return x.scatter(1, idx[:, None], value[:, None])


def _pred_finish(state: FJSPState) -> torch.Tensor:
    """The finish time of each operation's predecessor in its job, 0 for a
    job's first operation ``[B, O]``."""
    o = state.finish_times.shape[1]
    is_first = (torch.arange(o, device=state.start_op.device)[None, None, :]
                == state.start_op[..., None]).any(dim=1)
    prev = torch.cat([torch.zeros_like(state.finish_times[:, :1]),
                      state.finish_times[:, :-1]], dim=1)
    return torch.where(~is_first, prev, 0.0)


def op_is_ready(state: FJSPState) -> torch.Tensor:
    """bool [B, O]: unscheduled, and the job's previous operation is over."""
    return (_pred_finish(state) <= state.time[:, None]) & ~state.op_scheduled


@dataclasses.dataclass(frozen=True)
class FJSP(Env):
    name = "fjsp"
    num_jobs: int = 5
    num_mas: int = 3
    min_ops_per_job: int = 2
    max_ops_per_job: int = 4
    min_processing_time: int = 1
    max_processing_time: int = 20
    min_eligible_ma_per_op: int = 1
    max_eligible_ma_per_op: int = 2

    @property
    def n_ops_max(self) -> int:
        return self.num_jobs * self.max_ops_per_job

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """Random instances from ``generator`` (its own stream): each job
        ``min..max_ops_per_job`` operations, each operation eligible on
        ``min..max_eligible_ma_per_op`` machines picked by a random ranking,
        integer times in ``[min, max_processing_time]``."""
        device = resolve_device(device)
        b, j, m, o = batch_size, self.num_jobs, self.num_mas, self.n_ops_max

        def randint(lo, hi, shape):
            return torch.randint(lo, hi + 1, shape, generator=generator, device=device)

        n_ops = randint(self.min_ops_per_job, self.max_ops_per_job, (b, j))
        end_op = torch.cumsum(n_ops, dim=1) - 1
        start_op = torch.cat([torch.zeros_like(end_op[:, :1]), end_op[:, :-1] + 1], dim=1)
        pad_mask = torch.arange(o, device=device)[None, :] >= n_ops.sum(1, keepdim=True)
        n_eligible = randint(self.min_eligible_ma_per_op, self.max_eligible_ma_per_op, (b, o))
        n_eligible = torch.where(pad_mask, 0, n_eligible)
        scores = torch.rand((b, o, m), generator=generator, device=device)
        rank = torch.argsort(torch.argsort(-scores, dim=-1), dim=-1)
        eligible = rank < n_eligible[..., None]
        times = randint(self.min_processing_time, self.max_processing_time, (b, o, m)).float()
        return {
            "proc_times": torch.where(eligible, times, 0.0).transpose(1, 2).contiguous(),
            "pad_mask": pad_mask,
            "start_op_per_job": start_op,
            "end_op_per_job": end_op,
        }

    def reset(self, instances: Instance) -> FJSPState:
        proc = instances["proc_times"].float()
        pad_mask = instances["pad_mask"].bool()
        start_op = instances["start_op_per_job"].long()
        end_op = instances["end_op_per_job"].long()
        b, m, o = proc.shape
        j, dev = start_op.shape[1], proc.device
        ops = torch.arange(o, device=dev)
        job_ops_adj = ((ops[None, None, :] >= start_op[..., None])
                       & (ops[None, None, :] <= end_op[..., None])).float()
        job_ops_adj = job_ops_adj * (~pad_mask)[:, None, :]
        ops_seq_order = (job_ops_adj * (torch.cumsum(job_ops_adj, dim=2) - 1)).sum(1)
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return FJSPState(
            proc_times=proc,
            orig_proc_times=proc,
            pad_mask=pad_mask,
            start_op=start_op,
            end_op=end_op,
            job_ops_adj=job_ops_adj,
            ops_job_map=torch.argmax(job_ops_adj, dim=1),
            ops_seq_order=ops_seq_order.long(),
            start_times=torch.zeros((b, o), device=dev),
            finish_times=torch.full((b, o), INIT_FINISH, device=dev),
            ma_of_op=torch.full((b, o), -1, dtype=torch.long, device=dev),
            busy_until=torch.zeros((b, m), device=dev),
            next_op=start_op,
            op_scheduled=torch.zeros((b, o), dtype=torch.bool, device=dev),
            job_in_process=torch.zeros((b, j), dtype=torch.bool, device=dev),
            job_done=torch.zeros((b, j), dtype=torch.bool, device=dev),
            time=torch.zeros((b,), device=dev),
            i=zeros,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    # ---- the mask ----

    def _job_machine_feasible(self, state: FJSPState) -> torch.Tensor:
        """bool [B, J, M]: the job's next operation may start on the machine now."""
        infeasible = (state.job_done[:, :, None] | state.job_in_process[:, :, None]
                      | (state.busy_until > state.time[:, None])[:, None, :])
        next_proc = torch.gather(
            state.proc_times, 2,
            state.next_op[:, None, :].expand(-1, state.proc_times.shape[1], -1))  # [B, M, J]
        return ~(infeasible | (next_proc.transpose(1, 2) == 0))

    def action_mask(self, state: FJSPState) -> torch.Tensor:
        feasible = self._job_machine_feasible(state).reshape(state.done.shape[0], -1)
        return torch.cat([state.done[:, None], feasible & ~state.done[:, None]], dim=-1)

    # ---- transitions ----

    def _transit_once(self, state: FJSPState) -> FJSPState:
        """The clock to the next machine-idle event; operations that end by
        then finish, and a job whose last one does is done."""
        future = torch.where(state.busy_until > state.time[:, None], state.busy_until,
                             torch.inf)
        soonest = future.amin(dim=1)
        time = torch.where(torch.isfinite(soonest), soonest.clamp(max=1e12), state.time)
        curr_ops_end = torch.gather(state.finish_times, 1, state.next_op)
        op_finished = state.job_in_process & (curr_ops_end <= time[:, None])
        job_finished = op_finished & (state.next_op == state.end_op)
        job_done = state.job_done | job_finished
        return dataclasses.replace(
            state,
            time=time,
            next_op=torch.where(op_finished & ~job_finished, state.next_op + 1, state.next_op),
            job_in_process=state.job_in_process & ~op_finished,
            job_done=job_done,
            done=job_done.all(dim=1),
        )

    def _job_and_machine(self, state: FJSPState, action: torch.Tensor):
        """(job, machine) of a non-no-op action, 0-based (``action - 1``)."""
        return action // self.num_mas, action % self.num_mas

    def _make_step(self, state: FJSPState, action: torch.Tensor) -> FJSPState:
        job, machine = self._job_and_machine(state, action)
        op = torch.gather(state.next_op, 1, job[:, None])[:, 0]
        proc = state.proc_times[torch.arange(op.shape[0], device=op.device), machine, op]
        finish = state.time + proc
        op_col = torch.arange(state.proc_times.shape[2], device=op.device)[None, :] == op[:, None]
        job_row = torch.gather(state.job_ops_adj, 1,
                               job[:, None, None].expand(-1, 1, state.job_ops_adj.shape[2]))
        return dataclasses.replace(
            state,
            job_in_process=_set(state.job_in_process, job, True),
            op_scheduled=_set(state.op_scheduled, op, True),
            start_times=_set(state.start_times, op, state.time),
            finish_times=_set(state.finish_times, op, finish),
            ma_of_op=_set(state.ma_of_op, op, machine),
            busy_until=_set(state.busy_until, machine, finish),
            proc_times=torch.where(op_col[:, None, :], 0.0, state.proc_times),
            ops_seq_order=(state.ops_seq_order - job_row[:, 0].long()).clamp(min=0),
        )

    def step(self, state: FJSPState, action: torch.Tensor) -> FJSPState:
        action = action.long()
        is_noop = action == 0
        moved = self._make_step(state, (action - 1).clamp(min=0))
        new = _where_state(is_noop, state, moved)
        # advance the clock until some action is feasible (or the row is done)
        for _ in range(2 * (self.n_ops_max + self.num_mas) + 2):
            waiting = ~self._job_machine_feasible(new).flatten(1).any(dim=1) & ~new.done
            if not bool(waiting.any()):
                break
            new = _where_state(~waiting, new, self._transit_once(new))
        else:
            raise RuntimeError("FJSP: the clock found no feasible action")
        new = dataclasses.replace(new, i=state.i + 1)
        return _where_state(state.done, state, new)

    def reward(self, state: FJSPState, actions: torch.Tensor) -> torch.Tensor:
        """Minus the makespan: the latest finish of a real operation."""
        return -torch.where(state.pad_mask, -torch.inf, state.finish_times).amax(dim=1)

    # ---- lower bounds and readiness (stepwise PPO, L2D's features) ----

    def calc_lower_bound(self, state: FJSPState) -> torch.Tensor:
        """Each operation's earliest finish ``[B, O]`` (the reference's lower
        bound): the scheduled ones' finish times, the others' mean time over
        their machines (waits included) summed along the job."""
        maybe_start = _pred_finish(state)
        wait = (state.busy_until[:, :, None] - maybe_start[:, None, :]).clamp(min=0.0)
        ptw = torch.where(state.proc_times == 0, 0.0, state.proc_times + wait)
        count = (state.proc_times > 0).sum(1).clamp(min=0)
        ops_proc = ptw.sum(1) / (count + 1e-9)
        ops_proc = torch.where(state.op_scheduled, 0.0, ops_proc)
        sched = state.op_scheduled.float()
        assigned = state.job_ops_adj * sched[:, None, :]
        not_sched = state.job_ops_adj * (1.0 - sched[:, None, :])
        ft_rows = assigned * state.finish_times[:, None, :]
        first_diff = ft_rows - torch.cat([torch.zeros_like(ft_rows[..., :1]),
                                          ft_rows[..., :-1]], dim=-1)
        lb_end = not_sched * ops_proc[:, None, :] + assigned * first_diff
        lbs = (state.job_ops_adj * torch.cumsum(lb_end, dim=-1)).sum(1)
        return torch.nan_to_num(lbs, nan=0.0)

    def op_is_ready(self, state: FJSPState) -> torch.Tensor:
        return op_is_ready(state)

    @property
    def num_actions(self) -> int:
        return 1 + self.num_jobs * self.num_mas

    @property
    def max_steps(self) -> int:
        return self.n_ops_max + 1

    def check_solution_validity(self, instance, actions) -> None:
        pass  # the schedule is consistent by construction, as in the JAX package


@dataclasses.dataclass(frozen=True)
class JSSP(FJSP):
    """Job-Shop Scheduling: every job has ``num_mas`` operations, each on
    one machine, every machine once per job (Taillard's generator). An
    action names a job; its machine is the one its next operation needs."""

    name = "jssp"
    min_ops_per_job: int = 0  # unused
    max_ops_per_job: int = 0  # unused

    @property
    def n_ops_max(self) -> int:
        return self.num_jobs * self.num_mas

    @property
    def num_actions(self) -> int:
        return 1 + self.num_jobs

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        device = resolve_device(device)
        b, j, m = batch_size, self.num_jobs, self.num_mas
        o = j * m
        times = torch.randint(self.min_processing_time, self.max_processing_time + 1,
                              (b, j, m), generator=generator, device=device).float()
        perms = torch.argsort(torch.rand((b, j, m), generator=generator, device=device), dim=-1)
        ops_machine = perms.reshape(b, o)
        one_hot = torch.nn.functional.one_hot(ops_machine, m).transpose(1, 2).float()
        ar = torch.arange(j, device=device)
        return {
            "proc_times": one_hot * times.reshape(b, 1, o),
            "pad_mask": torch.zeros((b, o), dtype=torch.bool, device=device),
            "start_op_per_job": (ar * m)[None].expand(b, -1).contiguous(),
            "end_op_per_job": ((ar + 1) * m - 1)[None].expand(b, -1).contiguous(),
        }

    def action_mask(self, state: FJSPState) -> torch.Tensor:
        feasible_job = self._job_machine_feasible(state).any(dim=-1)
        return torch.cat([state.done[:, None], feasible_job & ~state.done[:, None]], dim=-1)

    def _job_and_machine(self, state: FJSPState, action: torch.Tensor):
        job = action
        op = torch.gather(state.next_op, 1, job[:, None])[:, 0]
        column = torch.gather(state.orig_proc_times, 2,
                              op[:, None, None].expand(-1, state.orig_proc_times.shape[1], 1))
        return job, torch.argmax((column[..., 0] > 0).to(torch.uint8), dim=1)
