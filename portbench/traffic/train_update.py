"""Training traffic: back-to-back REINFORCE updates, each on a batch of
``batch`` instances made on the device in set-up (``pool_batches`` of them,
cycled), as the trainer's inner step runs them.

Set-up builds one algorithm object, takes it from the seed through its first
``checked_steps`` updates on batches that all differ, keeping each update's
sampled tours and baseline values and the weights and Adam moments it left,
and hands the same object to the window. After the window the plain
reference follows those updates step by step: each from the weights and
moments the program held after the one before (the first from the seed's
weights), its loss over the program's tours and baseline values, with the
same batches and uniforms. Adam's first step moves every element by about
its learning rate whatever its gradient's size, so elements whose gradient
is round-off move by +-lr on either side, and two runs that each went their
own way would part by more than rounding after one update; following the
program keeps each comparison to one update's rounding. The stages that the
following skips are checked by themselves:

- ``sample_mismatch_share``: the share of rows, at the worst update, whose
  tour drawn by the reference with the same uniforms differs from the
  program's (a decision near a boundary of the cumulative distribution
  turns on the last bits);
- ``baseline_mismatch_share``: likewise, for the baseline's greedy rewards
  (beyond `reference.reinforce.BASELINE_RTOL`);
- ``loss_gap``: each update's loss, as a share of the mean size of its terms
  ``|(R - b) · log p|`` (the loss itself can cancel to near 0);
- ``grad_gap``: the first update's clipped gradient norm per weight, as Adam
  got it (its first moment after one step over ``1 - beta1``), the worst
  weight's gap of norms over the larger of its own and the median weight's
  reference norm;
- ``update_gap``: each update's change of each weight, likewise, over the
  elements the reference's first gradient moves, at the median weight, at
  the worst update. Moving are the weights whose first reference gradient
  has a root mean square of at least ``MOVING`` of the median weight's, and
  in them the elements of at least that size: a bias that a normalisation
  cancels, or the keys' part of a fused q/k/v bias under softmax, has a
  round-off gradient, and Adam moves it by round-off alone;
- ``update_gap_worst``: the same at the worst weight, so that a wrong step
  of one weight or one layer shows.

Parameters: ``batch``, ``pool_batches``, ``checked_steps``, ``lr``,
``grad_clip``, ``traced_steps``.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench.harness import counts, inputs, trace
from portbench.harness.cell import Cell, Outcome

KERNEL = "pointer_step_single"
MOVING = 1e-3


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t))


def _gaps(got: dict, want: dict) -> dict:
    """Per weight, the gap of norms over the larger of its own and the median
    weight's reference norm."""
    med = statistics.median(want.values())
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in want}


def update_gaps(got: dict, want: dict, step: int) -> dict:
    """Per moving weight, the gap of the norm of update ``step``'s change
    over its moving elements (`MOVING`)."""
    names = sorted(want["grad"])
    rms = {k: _norm(want["grad"][k]) / want["grad"][k].numel() ** 0.5 for k in names}
    cut = MOVING * statistics.median(rms.values())
    moves = {k: want["grad"][k].abs() >= cut for k in names}
    moving = [k for k in names if rms[k] >= cut and bool(moves[k].any())]
    return _gaps({k: _norm(got["update"][step][k][moves[k]]) for k in moving},
                 {k: _norm(want["update"][step][k][moves[k]]) for k in moving})


def judge(got: dict, want: dict) -> dict:
    """The judge's numbers: ``got`` and ``want`` hold per step ``loss``
    (and ``want`` its ``scale``, its ``sample_mismatch`` and
    ``baseline_mismatch``) and ``update`` by weight, and the first step's
    ``grad`` by weight."""
    names = sorted(want["grad"])
    updates = [update_gaps(got, want, k) for k in range(len(want["update"]))]
    grads = _gaps({k: _norm(got["grad"][k]) for k in names},
                  {k: _norm(want["grad"][k]) for k in names})
    return {
        "loss_gap": max(abs(a - b) / s for a, b, s in
                        zip(got["loss"], want["loss"], want["scale"])),
        "grad_gap": max(grads.values()),
        "update_gap": max(statistics.median(gaps.values()) for gaps in updates),
        "update_gap_worst": max(max(gaps.values()) for gaps in updates),
        "sample_mismatch_share": max(want["sample_mismatch"]),
        "baseline_mismatch_share": max(want["baseline_mismatch"]),
    }


def unjudgeable(got: dict, b: int, steps: int, checked: int) -> bool:
    """Whether the program's kept tours and values are not one whole batch
    per checked update (a fault; the reference cannot follow them)."""
    return (len(got["actions"]) != checked or len(got["baseline"]) != checked
            or any(tuple(a.shape) != (b, steps) for a in got["actions"])
            or any(tuple(v.shape) != (b,) for v in got["baseline"]))


def make_inputs(cell: Cell):
    """The weights, the pool of batches and the sampling stream of the seed."""
    cfg, p, dev = cell.cfg, cell.params, cell.device
    b = p["batch"]
    weights = inputs.make_weights(cell.reference.param_schema(cfg),
                                  inputs.generator(cell.seed, inputs.WEIGHTS, dev), dev)
    pool = inputs.make_instances(cfg, b * p["pool_batches"],
                                 inputs.generator(cell.seed, inputs.INSTANCES, dev), dev)
    batches = [{k: v[i * b:(i + 1) * b] for k, v in pool.items()}
               for i in range(p["pool_batches"])]
    return weights, batches, inputs.generator(cell.seed, inputs.SAMPLING, dev)


def run(cell: Cell) -> Outcome:
    cfg, p, dev = cell.cfg, cell.params, cell.device
    prog, ref = cell.program, cell.reference
    b, pool_n, checked = p["batch"], p["pool_batches"], p["checked_steps"]
    marks = {"imports": time.perf_counter()}
    weights, batches, sampling = make_inputs(cell)
    sampling_start = sampling.get_state()
    env = prog.make_env(cfg)
    policy = prog.make_policy(cfg, weights, dev)
    algo = prog.make_algorithm(cfg, policy, env, sampling, p)
    update = cell.hooks.get("update", lambda algo, inst: algo.update(inst))
    cell.sync()
    marks["inputs"] = time.perf_counter()

    # the first steps, the first of them the warm-up of the cell's one shape
    before = prog.kernel_launches()[KERNEL]
    got = {"loss": [], "states": [], "update": []}
    held = weights
    with prog.recording(algo) as rec:
        for k in range(checked):
            got["loss"].append(update(algo, batches[k])["loss"])
            got["states"].append(prog.optimizer_state(algo))
            got["update"].append({n: w - held[n] for n, w in got["states"][-1][0].items()})
            held = got["states"][-1][0]
            if k == 0:
                cell.sync()
                marks["first update"] = time.perf_counter()
                cell.expect_kernel(KERNEL, before)
                got["grad"] = {n: m / (1 - prog.adam_beta1(algo))
                               for n, m in got["states"][0][1].items()}
    got.update(rec)
    got["loss"] = [float(x) for x in got["loss"]]
    cell.sync()
    marks["checked updates"] = time.perf_counter()

    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(update(algo, batches[(checked + len(losses)) % pool_n])["loss"])
        if time.perf_counter() - t0 >= cell.seconds:
            break
    cell.sync()
    window_s = time.perf_counter() - t0
    steps = len(losses)

    records = None
    if cell.trace:
        # the device alone, then the host as well for the breakdown's labels
        k = p["traced_steps"]

        def updates(first):
            return [update(algo, batches[(checked + first + j) % pool_n]) for j in range(k)]

        _, tr = trace.record(lambda: updates(steps), host=False)
        _, labelled = trace.record(lambda: updates(steps + k), host=True)
        step_flops = 4 * counts.am_forward_flops(cfg, b)   # sampled rollout x3, baseline x1
        records = {
            "trace": tr, "labelled_trace": labelled,
            "decode_steps": k * 2 * ref.max_steps(cfg),
            "kernel_shapes": {KERNEL: (b, 1, ref.num_nodes(cfg), cfg["embed_dim"])},
            "model_flops": steps * step_flops,
            "model_flops_s": window_s,
        }
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = cell.memory_peak_bytes()
    del algo, policy, env, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sampling.set_state(sampling_start)
    notes = {}
    if unjudgeable(got, b, ref.max_steps(cfg), checked):
        checks = dict.fromkeys(cell.limits, float("inf"))
    else:
        want = ref_steps(cell, weights, batches[:checked], sampling, follow=got)
        checks = judge(got, want)
        notes = {"sample_mismatch_by_update": want["sample_mismatch"],
                 "worst_weight_by_update": [max(update_gaps(got, want, k).items(),
                                                key=lambda kv: kv[1]) for k in range(checked)]}
    return Outcome(
        window_start=t0,
        e2e={"train_rate": steps * b / window_s},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak,
        records=records,
        notes={"marks": marks, "steps": steps, "checked_losses": got["loss"], **notes})


def ref_steps(cell: Cell, weights: dict, batches: list, sampling: torch.Generator,
              **kw) -> dict:
    """The plain reference's steps (``kw``: `train_steps`' planted fault)."""
    from portbench.reference.reinforce import train_steps

    return train_steps(cell.reference, weights, cell.cfg, batches, sampling, lr=cell.params["lr"],
                       clip=cell.params["grad_clip"], **kw)
