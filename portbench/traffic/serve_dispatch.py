"""Serving traffic: dispatches of ``instances_per_dispatch`` instances through
the program's evaluation entry, offered at a fixed ``rate`` (dispatches per
second, evenly spaced: dispatch i is due ``i / rate`` s after the window
opens). The entry answers one dispatch at a time, so a dispatch is sent when
it is due or, if the last one has not answered yet, when it has. Above the
entry's capacity the client never waits and the cell measures the instances
answered per second (``solve_rate``); below it, each dispatch's latency from
the moment it was due to its answer (``solve_ms_p90``: a cell reports it only
where `BENCHMARK.json` lists it for that cell).

Parameters (the cell's file): ``method`` (`evaluate_policy`'s protocol,
`METHOD`: a later cell's protocol comes with a judge that replays it),
``instances_per_dispatch``, ``rate``, ``pool_dispatches`` (instances made in
set-up, cycled), ``traced_dispatches`` (each of a traced run's two profiled
stretches, after the timed window, on the same schedule), ``check_instances``
(answers judged after the window).

The judge takes a sample, drawn from the seed, of the instances answered in
the window and replays each served tour through the plain reference on
every symmetry of its instance, from its served start:

- ``logit_gap``: the widest amount by which a served step's clipped logit
  lies below the reference's best logit of that step, on the symmetry where
  the tour fits best; an infeasible or unfinished tour, or a served cost
  that is not its tour's length (beyond ``COST_RTOL``), reads infinite;
- ``cost_mismatch_share``: the share of sampled instances whose served cost
  differs by more than ``COST_RTOL`` from the best cost the reference's own
  rollouts find over every symmetry and start (covers the reward and the
  best-of selection).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.harness import counts, inputs, stats, trace
from portbench.harness.cell import Cell, Outcome

COST_RTOL = 1e-5    # one tour's length on two symmetries differs by ~1e-7


# the protocol of `evaluate_policy` the judge replays: POMO's, a greedy
# trajectory from every start on each of the 8 symmetries
METHOD = "multistart_greedy_augment_dihedral_8"
AUGS = 8
KERNEL = "pointer_step_grouped"


def method_shape(cfg: dict, method: str):
    """(starts, symmetries) of the evaluation protocol."""
    if method != METHOD:
        raise ValueError(f"protocol {method!r}: the judge replays {METHOD!r} alone")
    return cfg["num_loc"], AUGS


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in matrix products while inside (the control's precision)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_serve(cell: Cell, weights: dict, lower: bool):
    """The plain reference in the program's place (the control, ``lower``:
    its matrix products in TF32): a serve function of the program's form."""
    ref = cell.reference

    def serve(cfg, env, policy, inst, method, batch, device):
        starts, augs = method_shape(cfg, method)
        with torch.no_grad(), tf32(lower):
            ai = ref.augment8(inst)
            out = ref.rollout(weights, cfg, ai, starts=starts, mode="greedy")
        n = batch
        cost = out["cost"].reshape(augs, n, -1).transpose(0, 1).reshape(n, -1)
        best = cost.argmin(dim=1)
        acts = out["actions"].reshape(augs, n, -1, out["actions"].shape[-1])
        acts = acts.transpose(0, 1).reshape(n, -1, acts.shape[-1])[torch.arange(n), best]
        return (-cost[torch.arange(n), best]).cpu().numpy(), acts.cpu().numpy()

    return serve


def judge(cell: Cell, weights: dict, inst: dict, actions: torch.Tensor,
          reward: torch.Tensor) -> dict:
    """The judge's numbers over the served answers of ``inst``."""
    cfg, ref = cell.cfg, cell.reference
    starts, augs = method_shape(cfg, cell.params["method"])
    k = actions.shape[0]
    with torch.no_grad():
        ai = ref.augment8(inst)
        h = ref.encode(weights, cfg, ai)
        own = ref.rollout(weights, cfg, ai, starts=starts, mode="greedy", h=h)
        best = own["cost"].reshape(augs, k, -1).amin(dim=2).amin(dim=0)
        replay = ref.rollout(weights, cfg, ai, starts=starts, mode="force",
                             actions=actions.repeat(augs, 1)[:, None, :], h=h)
        gap = replay["gap"].reshape(augs, k).amin(dim=0)
        length = replay["cost"].reshape(augs, k)[0]
    gap = torch.where((-reward - length).abs() <= COST_RTOL * length, gap, float("inf"))
    same = (-reward - best).abs() <= COST_RTOL * best
    return {"logit_gap": float(gap.max()),
            "cost_mismatch_share": float((~same).float().mean())}


def run(cell: Cell) -> Outcome:
    cfg, p, dev = cell.cfg, cell.params, cell.device
    prog, ref = cell.program, cell.reference
    n, pool_n, method = p["instances_per_dispatch"], p["pool_dispatches"], p["method"]
    starts, augs = method_shape(cfg, method)
    marks = {"imports": time.perf_counter()}
    weights = inputs.make_weights(ref.param_schema(cfg), inputs.generator(cell.seed, inputs.WEIGHTS, dev), dev)
    env = prog.make_env(cfg)
    policy = prog.make_policy(cfg, weights, dev)
    pool = inputs.make_instances(cfg, n * pool_n, inputs.generator(cell.seed, inputs.INSTANCES, dev), dev)
    batches = [{k: v[i * n:(i + 1) * n] for k, v in pool.items()} for i in range(pool_n)]
    serve = cell.hooks["serve"](cell, weights) if "serve" in cell.hooks else prog.serve

    def dispatch(i):
        return serve(cfg, env, policy, batches[i % pool_n], method, n, dev)

    before = prog.kernel_launches()[KERNEL]
    cell.sync()
    marks["inputs"] = time.perf_counter()
    dispatch(0)                               # the cell's one shape, warmed up
    if "serve" not in cell.hooks:             # the program's own call
        cell.expect_kernel(KERNEL, before)
    cell.sync()
    marks["warm-up"] = time.perf_counter()

    def offered(start, count, served, lat, until=None):
        """Dispatches ``start``, ``start + 1``, ... on the schedule from now:
        ``count`` of them, or until one answers ``until`` s or more after
        the first was due. Returns the seconds from then to the last answer."""
        t0 = time.perf_counter()
        for j in range(count or 1 << 62):
            due = t0 + j / p["rate"]
            if due > time.perf_counter():
                time.sleep(due - time.perf_counter())
            served.append(dispatch(start + j))
            done = time.perf_counter()
            lat.append(done - due)
            if until is not None and done - t0 >= until:
                break
        return done - t0

    lat, served = [], []
    t0 = time.perf_counter()
    window_s = offered(0, 0, served, lat, until=cell.seconds)
    dispatches = len(served)

    records = None
    if cell.trace:
        # the device alone, then the host as well for the breakdown's labels
        k = p["traced_dispatches"]
        _, tr = trace.record(lambda: offered(dispatches, k, [], []), host=False)
        _, labelled = trace.record(lambda: offered(dispatches + k, k, [], []), host=True)
        records = {
            "trace": tr, "labelled_trace": labelled,
            "decode_steps": k * ref.max_steps(cfg),
            "kernel_shapes": {KERNEL: (n * augs, starts, ref.num_nodes(cfg), cfg["embed_dim"])},
            "model_flops": dispatches * counts.am_forward_flops(cfg, n * augs, starts),
            "model_flops_s": window_s,
        }
    peak = cell.memory_peak_bytes()
    del policy, env
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # every answer due, then a sample of them judged by the reference
    steps = ref.max_steps(cfg)
    answered, failed = [], 0
    for j, (rewards, actions) in enumerate(served):
        rewards, actions = np.asarray(rewards), np.asarray(actions)
        ok = rewards.shape == (n,) and actions.shape == (n, steps)
        good = np.isfinite(rewards) if ok else np.zeros(0, dtype=bool)
        failed += n - int(good.sum())
        answered += [(j, r) for r in np.flatnonzero(good)]
    pick = torch.randperm(len(answered), generator=inputs.generator(cell.seed, inputs.CHECK, "cpu"))
    pick = [answered[i] for i in pick[:p["check_instances"]].tolist()]
    if pick:
        inst = {key: torch.stack([batches[j % pool_n][key][r] for j, r in pick])
                for key in batches[0]}
        acts = torch.as_tensor(np.stack([served[j][1][r] for j, r in pick]), device=dev).long()
        reward = torch.as_tensor(np.array([served[j][0][r] for j, r in pick]), device=dev).float()
        checks = judge(cell, weights, inst, acts, reward)
    else:   # nothing answered: nothing to judge, and every instance failed
        checks = {"logit_gap": float("inf"), "cost_mismatch_share": 1.0}

    return Outcome(
        window_start=t0,
        e2e={"solve_rate": dispatches * n / window_s,
             "solve_ms_p90": stats.percentile(lat, 90) * 1e3},
        attempted=dispatches * n, failed=failed, checks=checks, memory_peak_bytes=peak,
        records=records,
        notes={"marks": marks, "dispatches": dispatches,
               "latency_samples_beyond_p90": stats.samples_beyond(dispatches, 90),
               "solve_ms_p50": stats.percentile(lat, 50) * 1e3,
               "judged_instances": len(pick)})
